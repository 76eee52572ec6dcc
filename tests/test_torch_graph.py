"""The port's graph package (``graph/``: Graph, the walk iterators,
GraphHuffman, DeepWalk, node2vec) against the JAX package's, on the CPU.

Tolerances: host code exactly (the adjacency arrays, every walk draw for
draw, the Huffman codes, points and vertex rows, the (center, context)
pairs and negatives each step is handed); whole fits (``DeepWalk``,
``Node2Vec``) within 1e-4 of the largest |x| of the JAX tables. Each case
of ``tests/test_graph.py``, the node2vec cases of
``tests/test_node2vec_distributed.py`` and the graph cases of
``tests/test_review_regressions.py`` is mirrored on the port. State
crosses with ``convert.deepwalk_from_jax`` / ``node2vec_from_jax``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graph as J
from deeplearning4j_tpu.graph import deepwalk as jdw
from deeplearning4j_tpu.graph import node2vec as jn2v

from deeplearning4j_tpu_torch.convert import (deepwalk_from_jax,
                                              node2vec_from_jax)
from deeplearning4j_tpu_torch.graph import (
    DeepWalk, Edge, Graph, GraphHuffman, Node2Vec, RandomWalkIterator,
    Vertex, WeightedRandomWalkIterator, node2vec_walks,
)
from deeplearning4j_tpu_torch.graph import deepwalk as pdw
from deeplearning4j_tpu_torch.graph import node2vec as pn2v
from deeplearning4j_tpu_torch.graph.walks import NoEdges

FIT = 1e-4
CPU = "cpu"


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * float(np.abs(want).max()), (err, tol)


def _both(n, edges, values=None):
    """The same graph in both packages: ``edges`` of (frm, to, weight,
    directed)."""
    g, jg = Graph(n, values), J.Graph(n, values)
    for frm, to, w, d in edges:
        g.add_edge(frm, to, weight=w, directed=d)
        jg.add_edge(frm, to, weight=w, directed=d)
    return g, jg


def _barbell(n=6):
    """Two cliques of n joined by one edge — clear community structure."""
    edges = [(side + i, side + j, 1.0, False) for side in (0, n)
             for i in range(n) for j in range(i + 1, n)]
    return _both(2 * n, edges + [(n - 1, n, 1.0, False)])


def _random_graph(V=60, E=300, seed=0):
    g = np.random.default_rng(seed)
    edges = [(int(a), int(b), float(w), bool(d)) for a, b, w, d in zip(
        g.integers(0, V, E), g.integers(0, V, E), g.uniform(0.1, 5.0, E),
        g.random(E) < 0.3)]
    return _both(V, edges)


def _spy(monkeypatch, mod, name):
    """Record every batch ``mod.name`` is handed (as numpy)."""
    calls = []
    real = getattr(mod, name)

    def spy(*args, **kw):
        calls.append([np.array(a) for a in args[2:-1]])
        return real(*args, **kw)
    monkeypatch.setattr(mod, name, spy)
    return calls


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# tests/test_graph.py on the port, held against the JAX package
# ---------------------------------------------------------------------------

def test_graph_basics():
    g, jg = _both(4, [(0, 1, 1.0, False), (1, 2, 1.0, True)],
                  values=["a", "b", "c", "d"])
    assert g.num_vertices() == 4
    assert g.get_vertex(0).value == "a"
    assert isinstance(g.get_vertex(0), Vertex) and Edge(0, 1).weight == 1.0
    assert sorted(g.get_connected_vertices(1)) == [0, 2]
    assert g.get_connected_vertices(2) == []  # directed: no back edge
    assert g.get_vertex_degree(3) == 0
    for v in range(4):
        assert g.get_connected_vertex_weights(v) == \
            jg.get_connected_vertex_weights(v)
    rg, rjg = _random_graph()
    for a, b in zip(rg.adjacency_arrays(), rjg.adjacency_arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_random_walks_follow_edges():
    g, jg = _barbell(4)
    walks = RandomWalkIterator(g, walk_length=10, seed=0).walks()
    assert walks.shape == (8, 10)
    edges = {(u, w) for u in range(8) for w in g.get_connected_vertices(u)}
    for row in walks:
        for a, b in zip(row[:-1], row[1:]):
            assert (int(a), int(b)) in edges
    np.testing.assert_array_equal(
        walks, J.RandomWalkIterator(jg, walk_length=10, seed=0).walks())


@pytest.mark.parametrize("weighted", [False, True])
def test_walks_equal_jax_draw_for_draw(weighted):
    """Three epochs of each iterator, with and without given starts, on a
    graph with directed edges, self-loops and disconnected vertices."""
    g, jg = _random_graph(seed=1)
    cls = WeightedRandomWalkIterator if weighted else RandomWalkIterator
    jcls = (J.WeightedRandomWalkIterator if weighted
            else J.RandomWalkIterator)
    it, jit = cls(g, 12, seed=4), jcls(jg, 12, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(it.walks(), jit.walks())
    starts = np.arange(0, 60, 3)
    np.testing.assert_array_equal(it.walks(starts), jit.walks(starts))
    assert [list(w) for w in it] == [list(w) for w in jit]


def test_disconnected_vertex_self_loops_or_raises():
    g, _ = _both(3, [(0, 1, 1.0, False)])
    walks = RandomWalkIterator(g, walk_length=5, seed=0).walks()
    row = walks[list(walks[:, 0]).index(2)]
    assert (row == 2).all()  # self-loop handling
    with pytest.raises(NoEdges):
        RandomWalkIterator(g, 5, no_edge_handling="exception").walks()


def test_weighted_walks_prefer_heavy_edges():
    g, jg = _both(3, [(0, 1, 100.0, False), (0, 2, 0.01, False)])
    starts = np.zeros(400, dtype=np.int64)
    walks = WeightedRandomWalkIterator(g, 2, seed=1).walks(starts)
    assert (walks[:, 1] == 1).mean() > 0.95
    np.testing.assert_array_equal(
        walks, J.WeightedRandomWalkIterator(jg, 2, seed=1).walks(starts))


def test_graph_huffman_codes():
    g, _ = _barbell(4)
    gh = GraphHuffman(g)
    codes = ["".join(map(str, gh.get_code(v))) for v in range(8)]
    assert len(set(codes)) == 8  # unique
    for i, a in enumerate(codes):
        for j, b in enumerate(codes):
            if i != j:
                assert not a.startswith(b)  # prefix-free
    assert gh.get_code_length(0) == len(gh.get_code(0))
    assert len(gh.get_path_inner_nodes(0)) == gh.get_code_length(0)


@pytest.mark.parametrize("which", ["barbell", "random"])
def test_graph_huffman_equals_jax(which):
    """Codes, points, rows and the padded arrays exactly, on equal degrees
    (the barbell's cliques: every tie broken as the JAX package breaks it)
    and on mixed ones."""
    g, jg = _barbell(5) if which == "barbell" else _random_graph(seed=2)
    gh, jgh = GraphHuffman(g), J.GraphHuffman(jg)
    for v in range(g.num_vertices()):
        assert gh.row_of(v) == jgh.row_of(v)
        assert gh.get_code(v) == jgh.get_code(v)
        assert gh.get_path_inner_nodes(v) == jgh.get_path_inner_nodes(v)
    for a, b in zip(gh.codes_points_mask(), jgh.codes_points_mask()):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_deepwalk_embeds_communities(monkeypatch):
    """The JAX gate on the port's fit, and the fit against the JAX one:
    every HS batch equal, the tables within 1e-4."""
    g, jg = _barbell(6)
    kw = dict(vector_size=16, window_size=4, learning_rate=0.05, epochs=5,
              walks_per_vertex=5, seed=2)
    jcalls = _spy(monkeypatch, jdw, "_hs_step")
    jd = J.DeepWalk(**kw).fit(jg, walk_length=20)
    pcalls = _spy(monkeypatch, pdw, "_hs_step")
    dw = DeepWalk(**kw, device=CPU).fit(g, walk_length=20)
    within = np.mean([dw.similarity(0, j) for j in range(1, 5)])
    across = np.mean([dw.similarity(0, j) for j in range(7, 11)])
    assert within > across, (within, across)
    nearest = dw.verticesNearest(1, top_n=4)
    assert sum(v < 6 for v in nearest) >= 3, nearest
    _same_batches(jcalls, pcalls)
    _close(dw.vertex_vectors, jd.vertex_vectors, FIT)
    _close(dw._syn1, jd._syn1, FIT)


def test_deepwalk_weighted_walks_run():
    g, jg = _barbell(4)
    dw = DeepWalk(vector_size=8, epochs=1, weighted_walks=True, seed=3,
                  device=CPU).fit(g, walk_length=8)
    assert dw.get_vertex_vector(0).shape == (8,)
    assert np.isfinite(dw.vertex_vectors).all()
    jd = J.DeepWalk(vector_size=8, epochs=1, weighted_walks=True,
                    seed=3).fit(jg, walk_length=8)
    _close(dw.vertex_vectors, jd.vertex_vectors, FIT)


def test_deepwalk_from_jax_answers_the_jax_queries():
    g, jg = _barbell(5)
    jd = J.DeepWalk(vector_size=8, epochs=2, walks_per_vertex=3,
                    seed=4).fit(jg, walk_length=10)
    dw = DeepWalk(vector_size=8, seed=99, device=CPU)
    dw.initialize(g)
    deepwalk_from_jax(jd, dw)
    for v in range(10):
        np.testing.assert_array_equal(dw.get_vertex_vector(v),
                                      jd.get_vertex_vector(v))
        assert dw.similarity(v, 3) == jd.similarity(v, 3)
        assert dw.verticesNearest(v, 4) == jd.verticesNearest(v, 4)
        assert dw.huffman.get_code(v) == jd.huffman.get_code(v)
    np.testing.assert_array_equal(dw._syn1, jd._syn1)
    dw.vertex_vectors[0, 0] += 1.0           # a copy, not the JAX array
    assert jd.vertex_vectors[0, 0] != dw.vertex_vectors[0, 0]


def test_fits_never_write_through_to_the_host_arrays(monkeypatch):
    """DeepWalk's steps update their tables in place: a tensor sharing
    ``vertex_vectors`` would change it mid-fit."""
    g, _ = _barbell(4)
    dw = DeepWalk(vector_size=8, seed=5, batch_size=32, device=CPU)
    dw.initialize(g)
    before, syn1 = dw.vertex_vectors, dw._syn1
    snap = before.copy()
    seen = []
    real = pdw._hs_step

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(np.array_equal(before, snap))
        return out
    monkeypatch.setattr(pdw, "_hs_step", spy)
    dw.fit(walk_length=8)
    assert seen and all(seen)
    assert not syn1.any() and dw._syn1.any()
    assert not np.array_equal(dw.vertex_vectors, snap)


# ---------------------------------------------------------------------------
# tests/test_node2vec_distributed.py's node2vec cases on the port
# ---------------------------------------------------------------------------

def _two_cliques(k=5):
    return _barbell(k)


def test_walk_shapes_and_connectivity():
    g, jg = _two_cliques(4)
    walks = node2vec_walks(g, walk_length=10, seed=1)
    assert walks.shape == (8, 10)
    offsets, neigh, _ = g.adjacency_arrays()
    for row in walks:
        for a, b in zip(row[:-1], row[1:]):
            assert b in neigh[offsets[a]:offsets[a + 1]]
    np.testing.assert_array_equal(walks, J.node2vec_walks(jg, 10, seed=1))


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.25, 0.25), (0.05, 3.0),
                                 (20.0, 0.5)])
def test_node2vec_walks_equal_jax_draw_for_draw(p, q):
    """The vectorized hops draw what the JAX package's walker loop draws,
    on a graph with directed edges, self-loops and dead ends."""
    g, jg = _random_graph(V=80, E=400, seed=3)
    starts = np.array([5, 5, 17, 0, 79, 42])
    np.testing.assert_array_equal(node2vec_walks(g, 15, p, q, seed=6),
                                  J.node2vec_walks(jg, 15, p, q, seed=6))
    np.testing.assert_array_equal(
        node2vec_walks(g, 9, p, q, starts=starts, seed=7),
        J.node2vec_walks(jg, 9, p, q, starts=starts, seed=7))


def test_return_parameter_biases_walks():
    """Small p => walker keeps returning to the previous vertex."""
    g, _ = _two_cliques(4)
    w_return = node2vec_walks(g, 30, p=0.05, q=1.0, seed=3)
    w_explore = node2vec_walks(g, 30, p=20.0, q=1.0, seed=3)

    def backtrack_rate(w):
        return np.mean(w[:, 2:] == w[:, :-2])

    assert backtrack_rate(w_return) > backtrack_rate(w_explore) + 0.1


def test_node2vec_embeds_communities(monkeypatch):
    g, jg = _two_cliques(5)
    kw = dict(vector_size=16, window_size=3, walk_length=20,
              walks_per_vertex=6, epochs=4, seed=5)
    jcalls = _spy(monkeypatch, jn2v, "_sgns_step")
    jm = J.Node2Vec(**kw).fit(jg)
    pcalls = _spy(monkeypatch, pn2v, "_sgns_step")
    n2v = Node2Vec(**kw, device=CPU).fit(g)
    same = np.mean([n2v.similarity(0, j) for j in range(1, 4)]
                   + [n2v.similarity(5, j) for j in range(6, 9)])
    cross = np.mean([n2v.similarity(i, j)
                     for i in range(0, 4) for j in range(6, 10)])
    assert same > cross, (same, cross)
    _same_batches(jcalls, pcalls)
    _close(n2v.vertex_vectors, jm.vertex_vectors, FIT)
    carried = Node2Vec(vector_size=16, device=CPU)
    node2vec_from_jax(jm, carried)
    assert carried.similarity(0, 7) == jm.similarity(0, 7)


# ---------------------------------------------------------------------------
# tests/test_review_regressions.py's graph cases on the port
# ---------------------------------------------------------------------------

def test_graph_values_accepts_numpy_array():
    g = Graph(4, values=np.array([10, 20, 30, 40]))
    assert g.get_vertex(2).value == 30


def test_weighted_walk_distribution():
    """Vectorized weighted sampling follows edge weights, draw for draw
    the JAX iterator's."""
    g, jg = _both(3, [(0, 1, 9.0, True), (0, 2, 1.0, True),
                      (1, 0, 1.0, True), (2, 0, 1.0, True)])
    counts = {1: 0, 2: 0}
    it = WeightedRandomWalkIterator(g, walk_length=2, seed=7)
    jit = J.WeightedRandomWalkIterator(jg, walk_length=2, seed=7)
    for _ in range(30):
        walks = list(it)
        assert walks == list(jit)
        for walk in walks:
            if walk[0] == 0:
                counts[walk[1]] += 1
    frac = counts[1] / max(counts[1] + counts[2], 1)
    assert 0.8 < frac < 1.0, counts


def test_weighted_walk_zero_weight_vertex_isolated():
    """A vertex whose out-edges all weigh 0 does not corrupt sampling for
    the others (no NaN in the global CDF)."""
    edges = [(2, 3, 0.0, True), (4, 0, 1.0, True), (4, 5, 3.0, True)]
    edges += [(v, 2, 1.0, True) for v in (0, 1, 3, 5)]
    g, jg = _both(6, edges)
    counts = {0: 0, 5: 0}
    it = WeightedRandomWalkIterator(g, walk_length=2, seed=3)
    jit = J.WeightedRandomWalkIterator(jg, walk_length=2, seed=3)
    for _ in range(60):
        walks = list(it)
        assert walks == list(jit)
        for walk in walks:
            if walk[0] == 4:
                counts[walk[1]] += 1
    frac5 = counts[5] / max(sum(counts.values()), 1)
    assert 0.6 < frac5 < 0.9, counts  # 3:1 weights => ~0.75


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (DeepWalk, Node2Vec):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
