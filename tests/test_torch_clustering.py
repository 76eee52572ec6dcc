"""The port's clustering package (``clustering/``: k-means, VPTree /
KDTree, t-SNE) against the JAX package's, on the CPU.

Tolerances: the device functions (``pairwise_sq_dist``, ``cosine_dist``,
``_lloyd_step``, ``_topk_neighbors``, ``_binary_search_perplexity``,
``_tsne_grad``) within 1e-5 of max(1, max |x|) of the JAX result,
squared distances within 1e-5 of max(1, max ||x||^2) of the points (the
matmul form cancels for near points, in both packages); whole fits
(k-means, a 20-iteration t-SNE) within 1e-4; host code (the k-means++
seeding, ``KDTree``) exactly. Assignments and neighbours are held where
the best and the next distance differ by more than the tolerance (a
near-tie may fall either way). A 300-iteration t-SNE is held by its
quality, as ``tests/test_clustering.py`` holds the JAX one: the gains
rule compares signs and amplifies one-ulp differences over a long fit.
State crosses with ``convert.kmeans_from_jax``. Each case of
``tests/test_clustering.py`` and the k-means / KDTree cases of
``tests/test_review_regressions.py`` is mirrored on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.clustering import (KDTree as JKDTree,
                                           KMeansClustering as JKMeans,
                                           Tsne as JTsne, VPTree as JVPTree)
from deeplearning4j_tpu.clustering import distance as jdist
from deeplearning4j_tpu.clustering import kmeans as jkm
from deeplearning4j_tpu.clustering import knn as jknn
from deeplearning4j_tpu.clustering import tsne as jtsne

from deeplearning4j_tpu_torch.clustering import (
    Cluster, ClusterSet, KDTree, KMeansClustering, Point, Tsne, VPTree,
)
from deeplearning4j_tpu_torch.clustering import distance as pdist
from deeplearning4j_tpu_torch.clustering import kmeans as pkm
from deeplearning4j_tpu_torch.clustering import knn as pknn
from deeplearning4j_tpu_torch.clustering import tsne as ptsne
from deeplearning4j_tpu_torch.convert import kmeans_from_jax

FN, FIT = 1e-5, 1e-4
CPU = "cpu"


def _close(got, want, tol, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if scale is None:
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, tol * scale)


def _sq_scale(*xs):
    return max(1.0, max(float((np.asarray(x, np.float64) ** 2).sum(1).max())
                        for x in xs))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return np.asarray(a)


def _blobs(n_per=50, d=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[5.0] * d, [-5.0] * d,
                        [5.0] * (d // 2) + [-5.0] * (d - d // 2)])
    pts = np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers])
    labels = np.repeat(np.arange(3), n_per)
    return pts.astype(np.float32), labels


def _clear(dist, tol):
    """Rows whose best distance beats the second by more than ``tol``."""
    part = np.sort(np.asarray(dist, np.float64), axis=1)
    return part[:, 1] - part[:, 0] > tol


def _same_neighbours(gi, gd, ji, jd, tol):
    """Equal indices wherever a neighbour's distance is apart from its
    sorted neighbours' by more than ``tol``; equal distances always."""
    gd, jd = np.asarray(gd, np.float64), np.asarray(jd, np.float64)
    _close(gd, jd, tol, 1.0)
    pad = np.full((jd.shape[0], 1), np.inf)
    gap = np.minimum(np.diff(np.concatenate([-pad, jd], 1), axis=1),
                     np.diff(np.concatenate([jd, pad], 1), axis=1))
    clear = gap > tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(gi)[clear], np.asarray(ji)[clear])


# ---------------------------------------------------------------------------
# the device functions
# ---------------------------------------------------------------------------

def test_distances_match_jax():
    g = np.random.default_rng(0)
    a = g.normal(size=(37, 9)).astype(np.float32) * 3
    b = np.concatenate([a[:5] + 1e-4, g.normal(size=(20, 9)) * 3]).astype(
        np.float32)
    b[3] = 0.0                                       # a zero row: the floor
    _close(pdist.pairwise_sq_dist(_t(a), _t(b)),
           jdist.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b)), FN,
           _sq_scale(a, b))
    assert float(pdist.pairwise_sq_dist(_t(a), _t(a)).min()) >= 0.0
    _close(pdist.cosine_dist(_t(a), _t(b)),
           jdist.cosine_dist(jnp.asarray(a), jnp.asarray(b)), FN)


@pytest.mark.parametrize("cosine", [False, True])
def test_lloyd_step_matches_jax(cosine):
    """Three chained steps: centers and inertia within 1e-5 of
    max(1, max |x|); assignments equal on clearly assigned rows. A
    cluster no point picks (a far center; under cosine one at an angle
    from every blob) keeps its center."""
    x, _ = _blobs(40, 6, seed=1)
    far = (np.array([[1, -1, 1, -1, 1, -1]], np.float32) if cosine
           else np.ones((1, 6), np.float32)) * 50.0
    c0 = np.concatenate([x[[0, 40, 80, 1]], far])
    pc, jc = _t(c0), jnp.asarray(c0)
    for _ in range(3):
        d = _np((jdist.cosine_dist if cosine else jdist.pairwise_sq_dist)(
            jnp.asarray(x), jc))
        pc, pa, pi = pkm._lloyd_step(_t(x), pc, 5, cosine)
        jc, ja, ji = jkm._lloyd_step(jnp.asarray(x), jc, 5, cosine)
        scale = _sq_scale(x, c0) if not cosine else 1.0
        clear = _clear(d, FN * scale)
        np.testing.assert_array_equal(_np(pa)[clear], _np(ja)[clear])
        _close(pc, jc, FN)
        _close(float(pi), float(ji), FN, max(1.0, abs(float(ji))))
    np.testing.assert_array_equal(_np(pc)[4], c0[4])


@pytest.mark.parametrize("cosine", [False, True])
def test_topk_neighbors_matches_jax(cosine):
    """Distances within the tolerance (squared ones against max ||x||^2);
    neighbours equal away from near-ties; exact duplicates tie and both
    packages list the lower index first."""
    g = np.random.default_rng(3)
    pts = g.normal(size=(120, 8)).astype(np.float32)
    pts[50] = pts[7]                                 # an exact tie
    q = np.concatenate([pts[:6] + 0.01, g.normal(size=(10, 8))]).astype(
        np.float32)
    pd, pi = pknn._topk_neighbors(_t(q), _t(pts), 9, cosine)
    jd, ji = jknn._topk_neighbors(jnp.asarray(q), jnp.asarray(pts), 9,
                                  cosine)
    pd, pi, jd, ji = _np(pd), _np(pi), _np(jd), _np(ji)
    if cosine:
        _same_neighbours(pi, pd, ji, jd, FN)
    else:
        tol = FN * _sq_scale(pts, q)
        _same_neighbours(pi, pd ** 2, ji, jd.astype(np.float64) ** 2, tol)
    row = np.flatnonzero((ji == 7).any(1))[0]
    k = list(pi[row]).index(7)
    assert pi[row][k + 1] == 50 and list(ji[row]).index(7) == k


def test_binary_search_perplexity_matches_jax():
    g = np.random.default_rng(4)
    x = g.normal(size=(60, 5)).astype(np.float32)
    d2 = np.array(jdist.pairwise_sq_dist(jnp.asarray(x), jnp.asarray(x)))
    np.fill_diagonal(d2, np.inf)
    for perp in (5.0, 20.0):
        target = np.log(np.float32(perp))
        got = ptsne._binary_search_perplexity(_t(d2), _t(target))
        want = jtsne._binary_search_perplexity(jnp.asarray(d2),
                                               jnp.asarray(target))
        _close(got, want, FN)
        assert np.allclose(_np(got).sum(1), 1.0, atol=1e-5)


def test_tsne_grad_matches_jax():
    g = np.random.default_rng(5)
    y = g.normal(size=(70, 2)).astype(np.float32)
    p = g.random((70, 70)).astype(np.float32)
    p = (p + p.T) / (2 * p.sum())
    np.fill_diagonal(p, 1e-12)
    for scale in (1.0, 12.0):
        pg, pk = ptsne._tsne_grad(_t(y), _t(p * scale))
        jg, jk = jtsne._tsne_grad(jnp.asarray(y), jnp.asarray(p * scale))
        _close(pg, jg, FN)
        _close(float(pk), float(jk), FN, max(1.0, abs(float(jk))))


def test_tsne_short_fit_matches_jax():
    """20 iterations (inside the exaggeration phase, momentum 0.5): the
    P matrix within 1e-5, the embedding within 1e-4 of its largest |y|
    (no floor of 1: it stays near 2e-3) and KL within 1e-4. The gains
    rule makes a short fit of 150 points chaotic at larger steps: at the
    default learning rate of 200 |y| jumps from 0.5 to ~77 at the third
    iteration, and at 10 an input changed by 1e-7 of itself moves y by
    up to 5e-4 of its size within 20 iterations; at 1.0 (perplexity 30)
    an input changed by 1e-6 moves it by ~1e-6."""
    x, _ = _blobs(n_per=50, d=10, seed=6)
    kw = dict(perplexity=30, max_iter=20, seed=7, learning_rate=1.0)
    pt, jt = Tsne(**kw, device=CPU), JTsne(**kw)
    _close(pt._p_matrix(x), jt._p_matrix(x), FN)
    y, jy = pt.fit(x), jt.fit(x)
    _close(y, jy, FIT, float(np.abs(jy).max()))
    _close(pt.kl_divergence_, jt.kl_divergence_, FIT,
           max(1.0, abs(jt.kl_divergence_)))


# ---------------------------------------------------------------------------
# tests/test_clustering.py on the port, held against the JAX fits
# ---------------------------------------------------------------------------

def test_kmeans_recovers_blobs():
    x, labels = _blobs()
    km = KMeansClustering.setup(3, max_iterations=50, device=CPU).fit(x)
    jkm_ = JKMeans.setup(3, max_iterations=50).fit(x)
    mapped = set()
    for c in range(3):
        vals, counts = np.unique(km.labels_[labels == c], return_counts=True)
        assert counts.max() >= 45  # >=90% pure
        mapped.add(int(vals[np.argmax(counts)]))
    assert len(mapped) == 3
    assert km.inertia_ < 2500
    np.testing.assert_array_equal(km.labels_, jkm_.labels_)
    _close(km.cluster_centers_, jkm_.cluster_centers_, FIT)
    _close(km.inertia_, jkm_.inertia_, FIT, jkm_.inertia_)
    assert km.n_iter_ == jkm_.n_iter_


def test_kmeans_predict_matches_fit_assignments():
    x, _ = _blobs()
    km = KMeansClustering(3, seed=1, device=CPU).fit(x)
    np.testing.assert_array_equal(km.predict(x), km.labels_)
    # the JAX model's state carried across predicts as the JAX model does
    jm = JKMeans(3, seed=1).fit(x)
    carried = KMeansClustering(3, seed=1, device=CPU)
    kmeans_from_jax(jm, carried)
    q = np.random.default_rng(8).normal(size=(64, 4)).astype(np.float32) * 5
    np.testing.assert_array_equal(carried.predict(q), jm.predict(q))
    np.testing.assert_array_equal(carried.labels_, jm.labels_)
    assert carried.inertia_ == jm.inertia_ and carried.n_iter_ == jm.n_iter_


def test_kmeans_cosine_distance():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(40, 6)) + np.array([10, 0, 0, 0, 0, 0])
    b = rng.normal(size=(40, 6)) + np.array([0, 10, 0, 0, 0, 0])
    x = np.concatenate([a, b]).astype(np.float32)
    km = KMeansClustering(2, distance="cosine", seed=3, device=CPU).fit(x)
    assert len(np.unique(km.labels_[:40])) == 1
    assert km.labels_[0] != km.labels_[40]
    jm = JKMeans(2, distance="cosine", seed=3).fit(x)
    np.testing.assert_array_equal(km.labels_, jm.labels_)
    _close(km.cluster_centers_, jm.cluster_centers_, FIT)


def test_kmeans_apply_to_cluster_set():
    x, _ = _blobs(10)
    points = [Point(i, row) for i, row in enumerate(x)]
    cs = KMeansClustering(3, seed=4, device=CPU).apply_to(points)
    assert isinstance(cs, ClusterSet)
    assert all(isinstance(c, Cluster) for c in cs.get_clusters())
    assert cs.get_cluster_count() == 3
    assert sum(len(c.points) for c in cs.get_clusters()) == len(points)
    assert cs.centers().shape == (3, 4)
    jcs = JKMeans(3, seed=4).apply_to(points)
    assert [[p.idx for p in c.points] for c in cs.get_clusters()] == \
        [[p.idx for p in c.points] for c in jcs.get_clusters()]


def test_kmeans_unknown_distance_raises():
    with pytest.raises(ValueError, match="distance"):
        KMeansClustering(2, distance="manhattan", device=CPU)


def test_kmeans_seeding_is_the_jax_seeding():
    """k-means++ draws on the host: the same centers exactly."""
    x, _ = _blobs(30, 5, seed=9)
    for k in (1, 3, 7):
        a = KMeansClustering(k, seed=11, device=CPU)._init_centers(
            x, np.random.default_rng(11))
        b = JKMeans(k, seed=11)._init_centers(x, np.random.default_rng(11))
        np.testing.assert_array_equal(a, b)


def test_vptree_search_matches_numpy():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(100, 8)).astype(np.float32)
    tree = VPTree(pts, device=CPU)
    q = pts[7] + 0.01
    idx, dist = tree.search(q, 5)
    ref = np.argsort(np.linalg.norm(pts - q, axis=1))[:5]
    np.testing.assert_array_equal(np.sort(idx), np.sort(ref))
    assert idx[0] == 7
    assert dist[0] == pytest.approx(np.linalg.norm(pts[7] - q), abs=1e-4)
    jidx, jdist_ = JVPTree(pts).search(q, 5)
    np.testing.assert_array_equal(idx, jidx)
    _close(dist ** 2, np.asarray(jdist_, np.float64) ** 2, FN,
           _sq_scale(pts, q[None]))
    assert tree.search(pts[:3], 200)[0].shape == (3, 100)   # k > N


def test_kdtree_nn():
    pts = np.eye(4, dtype=np.float32) * 3
    t = KDTree(pts)
    q = np.array([2.9, 0, 0, 0], np.float32)
    i, d = t.nn(q)
    assert i == 0 and d == pytest.approx(0.1, abs=1e-5)
    assert (i, d) == JKDTree(pts).nn(q)


def test_vptree_cosine():
    pts = np.array([[1, 0], [0, 1], [-1, 0]], np.float32)
    q = np.array([0.9, 0.1], np.float32)
    idx, dist = VPTree(pts, distance="cosine", device=CPU).search(q, 2)
    jidx, jd = JVPTree(pts, distance="cosine").search(q, 2)
    assert idx[0] == 0
    np.testing.assert_array_equal(idx, jidx)
    _close(dist, jd, FN)
    with pytest.raises(ValueError, match="distance"):
        VPTree(pts, distance="manhattan", device=CPU)


def test_tsne_separates_blobs():
    x, labels = _blobs(n_per=30, d=10, seed=6)
    ts = Tsne(perplexity=10, max_iter=300, seed=7, device=CPU)
    y = ts.fit(x)
    assert y.shape == (90, 2)
    assert np.isfinite(y).all()
    means = np.stack([y[labels == c].mean(axis=0) for c in range(3)])
    spread = np.mean([y[labels == c].std() for c in range(3)])
    min_gap = min(np.linalg.norm(means[i] - means[j])
                  for i in range(3) for j in range(i + 1, 3))
    assert min_gap > 2 * spread, (min_gap, spread)
    assert ts.kl_divergence_ is not None and ts.kl_divergence_ < 1.5


def test_kdtree_real_tree_matches_bruteforce():
    """The host k-d tree against the brute-force VPTree on the port, and
    its answers exactly the JAX KDTree's."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(200, 5)).astype(np.float32)
    tree, jtree = KDTree(pts), JKDTree(pts)
    brute = VPTree(pts, device=CPU)
    for _ in range(10):
        q = rng.normal(size=5).astype(np.float32)
        ti, td = tree.search(q, 7)
        bi, bd = brute.search(q, 7)
        np.testing.assert_allclose(np.sort(td), np.sort(bd), rtol=1e-5)
        assert set(ti.tolist()) == set(bi.tolist())
        ji, jd = jtree.search(q, 7)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    with pytest.raises(ValueError, match="single query"):
        tree.search(pts[:2], 1)


def test_kdtree_insert_and_nn():
    tree, jtree = KDTree(dims=2), JKDTree(dims=2)
    for p in ([0.0, 0.0], [5.0, 5.0], [1.0, 1.0], [-3.0, 2.0]):
        tree.insert(np.array(p, np.float32))
        jtree.insert(np.array(p, np.float32))
    assert len(tree) == 4
    q = np.array([0.9, 0.9], np.float32)
    idx, d = tree.nn(q)
    np.testing.assert_allclose(tree.points[idx], [1.0, 1.0])
    assert (idx, d) == jtree.nn(q)
    assert tree._left == jtree._left and tree._right == jtree._right
    tree2 = KDTree(np.array([[0, 0], [2, 2]], np.float32))
    tree2.insert(np.array([0.4, 0.4], np.float32))
    idx2, _ = tree2.nn(np.array([0.5, 0.5], np.float32))
    np.testing.assert_allclose(tree2.points[idx2], [0.4, 0.4])
    with pytest.raises(ValueError, match="dims"):
        KDTree()


# ---------------------------------------------------------------------------
# tests/test_review_regressions.py's k-means and KDTree cases
# ---------------------------------------------------------------------------

def test_kmeans_degenerate_duplicate_points():
    """Fewer than k distinct points: the seeding picks uniformly."""
    x = np.tile(np.array([[1.0, 2.0, 3.0]], np.float32), (20, 1))
    km = KMeansClustering(3, max_iterations=5, device=CPU).fit(x)
    assert km.cluster_centers_.shape == (3, 3)
    assert (km.predict(x) >= 0).all()
    jm = JKMeans(3, max_iterations=5).fit(x)
    np.testing.assert_array_equal(km.cluster_centers_, jm.cluster_centers_)
    np.testing.assert_array_equal(km.labels_, jm.labels_)


def test_kdtree_sorted_insert_chain_no_recursion_error():
    """A chain-shaped insert-built tree (sorted inserts, no rebalancing)
    still answers queries (the search is iterative)."""
    tree = KDTree(dims=1)
    for i in range(3000):
        tree.insert(np.array([float(i)], np.float32))
    idx, d = tree.nn(np.array([1500.2], np.float32))
    np.testing.assert_allclose(tree.points[idx], [1500.0])


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((3, 2), np.float32)
    for make in (lambda: KMeansClustering(2), lambda: VPTree(pts),
                 lambda: Tsne()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
