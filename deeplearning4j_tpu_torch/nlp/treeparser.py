"""Constituency tree parsing + vectorization for recursive models.

Ref: deeplearning4j-nlp-uima text/corpora/treeparser/ — TreeParser.java
(OpenNLP chunker output → trees), TreeFactory.java, HeadWordFinder.java,
BinarizeTreeTransformer.java, CollapseUnaries.java, TreeIterator.java,
TreeVectorizer.java. That stack feeds binarized, head-annotated
constituency trees into recursive networks.

This module is the same capability on the annotator pipeline: a
rule-based shallow chunker (the OpenNLP-chunker analog) builds
NP/VP/PP/ADJP chunk trees over POS-tagged tokens; transformers binarize
and collapse unaries; a head-rule table marks head words; and the
vectorizer attaches word vectors at leaves and composes parent vectors
bottom-up with a tanh(W[l;r]+b) cell on the device — the classic
recursive-NN composition (one [2D, D] matmul per internal node).
Penn-bracket serialization round-trips trees as text.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.annotators import (
    AnnotatorPipeline, POSAnnotator, SentenceAnnotator, TokenizerAnnotator,
)


@dataclass
class Tree:
    """A constituency tree node (ref: the Tree type TreeFactory builds).
    Leaves carry the token in ``value``; internal nodes a phrase label."""
    label: str
    children: List["Tree"] = field(default_factory=list)
    value: Optional[str] = None          # token text (leaves)
    head_word: Optional[str] = None      # set by HeadWordFinder
    vector: Optional[np.ndarray] = None  # set by TreeVectorizer

    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        return [l for c in self.children for l in c.leaves()]

    def tokens(self) -> List[str]:
        return [l.value for l in self.leaves()]

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def preorder(self) -> List["Tree"]:
        out = [self]
        for c in self.children:
            out.extend(c.preorder())
        return out

    # ---------------------------------------------------- penn round-trip
    def to_penn(self) -> str:
        if self.is_leaf():
            return f"({self.label} {self.value})"
        # a mixed node (value + children, e.g. after CollapseUnaries)
        # keeps its token inline so the round-trip is lossless
        val = f" {self.value}" if self.value is not None else ""
        return (f"({self.label}{val} "
                + " ".join(c.to_penn() for c in self.children) + ")")

    @staticmethod
    def from_penn(text: str) -> "Tree":
        """Parse a Penn-bracket string (inverse of ``to_penn``)."""
        toks = text.replace("(", " ( ").replace(")", " ) ").split()
        pos = 0

        def parse() -> Tree:
            nonlocal pos
            assert toks[pos] == "(", toks[pos:pos + 3]
            pos += 1
            label = toks[pos]
            pos += 1
            node = Tree(label)
            if toks[pos] != "(" and toks[pos] != ")":
                node.value = toks[pos]
                pos += 1
            while toks[pos] == "(":
                node.children.append(parse())
            assert toks[pos] == ")", toks[pos:pos + 3]
            pos += 1
            return node

        return parse()


# ---------------------------------------------------------------------------
# shallow chunking parser (the OpenNLP chunker analog)
# ---------------------------------------------------------------------------

# chunk grammar over POS tags, applied greedily left-to-right, earlier
# rules first (classic base-NP/VP/PP chunking)
_CHUNK_RULES = [
    ("PP", ["IN"], ["DT", "PRP$", "JJ", "NN", "NNS", "NNP", "CD"]),
    ("NP", [], ["DT", "PRP$", "JJ", "NN", "NNS", "NNP", "CD"]),
    ("VP", [], ["MD", "VB", "VBZ", "VBD", "VBG", "RB", "TO"]),
    ("ADJP", [], ["JJ", "RB"]),
]


class TreeParser:
    """Sentence text → chunked constituency tree
    (ref: treeparser/TreeParser.java — there via UIMA/OpenNLP chunker;
    here via the annotator pipeline's POS tags + a chunk grammar)."""

    def __init__(self, pipeline: Optional[AnnotatorPipeline] = None):
        self._pipe = pipeline or AnnotatorPipeline(
            [SentenceAnnotator(), TokenizerAnnotator(), POSAnnotator()])

    def parse_sentence(self, tagged: List[tuple]) -> Tree:
        """tagged: [(token, pos)] for ONE sentence → Tree('S', chunks)."""
        root = Tree("S")
        i, n = 0, len(tagged)
        while i < n:
            tok, pos = tagged[i]
            matched = False
            for label, openers, members in _CHUNK_RULES:
                j = i
                if openers:
                    if pos not in openers:
                        continue
                    j = i + 1
                k = j
                while k < n and tagged[k][1] in members:
                    k += 1
                if k > j or (openers and j > i):
                    # both branches guarantee k > i: the chunk is nonempty
                    node = Tree(label)
                    for t, p in tagged[i:k]:
                        node.children.append(Tree(p, value=t))
                    root.children.append(node)
                    i = k
                    matched = True
                    break
            if not matched:
                root.children.append(Tree(pos, value=tok))
                i += 1
        return root

    def trees_for(self, text: str) -> List[Tree]:
        """All sentence trees of a document (ref: TreeParser.getTrees)."""
        cas = self._pipe.process(text)
        trees = []
        for sent in cas.select("sentence"):
            tagged = [(t.covered_text(cas.text), t.features.get("pos", "NN"))
                      for t in cas.covered("token", sent)]
            tagged = [(t, p) for t, p in tagged if p not in (".", "SYM")]
            if tagged:
                trees.append(self.parse_sentence(tagged))
        return trees


# ---------------------------------------------------------------------------
# transformers (ref: transformer/TreeTransformer impls)
# ---------------------------------------------------------------------------

class BinarizeTreeTransformer:
    """Right-binarize n-ary nodes with @label intermediates
    (ref: BinarizeTreeTransformer.java)."""

    def transform(self, tree: Tree) -> Tree:
        if tree.is_leaf():
            return tree
        kids = [self.transform(c) for c in tree.children]
        while len(kids) > 2:
            right = Tree(f"@{tree.label}", children=kids[-2:])
            kids = kids[:-2] + [right]
        return Tree(tree.label, children=kids, value=tree.value,
                    head_word=tree.head_word)


class CollapseUnaries:
    """Collapse unary chains X→Y→... to the bottom node, keeping the top
    label (ref: CollapseUnaries.java)."""

    def transform(self, tree: Tree) -> Tree:
        value = tree.value
        while len(tree.children) == 1 and not tree.children[0].is_leaf():
            # keep the TOP label; a token value on the chain survives
            tree = Tree(tree.label, children=tree.children[0].children,
                        value=value or tree.children[0].value,
                        head_word=tree.head_word)
            value = tree.value
        return Tree(tree.label,
                    children=[self.transform(c) for c in tree.children],
                    value=value, head_word=tree.head_word)


class HeadWordFinder:
    """Per-phrase head rules (ref: HeadWordFinder.java — Collins-style
    head tables; here the common cases)."""

    _RULES = {
        "NP": (["NN", "NNS", "NNP", "PRP"], "last"),
        "@NP": (["NN", "NNS", "NNP", "PRP"], "last"),
        "VP": (["VB", "VBZ", "VBD", "VBG", "MD"], "first"),
        "@VP": (["VB", "VBZ", "VBD", "VBG", "MD"], "first"),
        "PP": (["IN", "TO"], "first"),
        "ADJP": (["JJ"], "last"),
        # '@S' before 'NP': a binarization intermediate hides the VP, so
        # the verb head must flow up through it, not lose to a left NP
        "S": (["VP", "@S", "NP"], "first"),
        "@S": (["VP", "@S", "NP"], "first"),
    }

    def annotate(self, tree: Tree) -> Tree:
        if tree.is_leaf():
            tree.head_word = tree.value
            return tree
        for c in tree.children:
            self.annotate(c)
        prefs, order = self._RULES.get(tree.label, (None, "first"))
        kids = tree.children if order == "first" else tree.children[::-1]
        head = None
        if prefs:
            for pref in prefs:
                for c in kids:
                    if c.label == pref or c.label.startswith(pref):
                        head = c
                        break
                if head:
                    break
        head = head or kids[0]
        tree.head_word = head.head_word
        return tree


class TreeIterator:
    """Iterate parsed trees over documents
    (ref: treeparser/TreeIterator.java)."""

    def __init__(self, documents: Sequence[str],
                 parser: Optional[TreeParser] = None,
                 binarize: bool = True):
        self._docs = list(documents)
        self._parser = parser or TreeParser()
        self._binarize = binarize

    def __iter__(self):
        b = BinarizeTreeTransformer()
        for doc in self._docs:
            for tree in self._parser.trees_for(doc):
                yield b.transform(tree) if self._binarize else tree


# ---------------------------------------------------------------------------
# vectorizer (ref: TreeVectorizer.java)
# ---------------------------------------------------------------------------

class TreeVectorizer:
    """Attach word vectors to leaves and compose parents bottom-up with
    the recursive cell v = tanh(W [l; r] + b) (unary: v = child) — one
    [2D, D] matmul per internal node, on the vectorizer's device
    (``device=None``: the CUDA card, raising without one; ``"cpu"``).

    ``lookup`` maps token → vector (e.g. ``table.get_word_vector``);
    OOV tokens get zeros. Parses + binarizes internally so every internal
    node has ≤ 2 children. A tree's leaf vectors go to the device in one
    copy and its nodes' vectors come back in one.
    """

    def __init__(self, lookup: Callable[[str], Optional[np.ndarray]],
                 dim: int, seed: int = 0, device=None):
        self._lookup = lookup
        self.dim = dim
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        scale = 1.0 / np.sqrt(2 * dim)
        self.W = torch.tensor(
            (rng.normal(size=(2 * dim, dim)) * scale).astype(np.float32),
            device=self.device)
        self.b = torch.zeros((dim,), dtype=torch.float32, device=self.device)
        self._parser = TreeParser()
        self._binarizer = BinarizeTreeTransformer()
        self._heads = HeadWordFinder()

    def _compose(self, l, r):
        return torch.tanh(torch.cat([l, r]) @ self.W + self.b)

    def _leaf_vec(self, token: str) -> np.ndarray:
        v = self._lookup(token)
        if v is None:
            return np.zeros((self.dim,), np.float32)
        return np.asarray(v, np.float32)

    def _post_order(self, tree: Tree, out: List[Tree]) -> None:
        if not tree.is_leaf():
            if len(tree.children) > 2:
                # composing only the first two would be silently wrong
                raise ValueError(
                    f"node {tree.label!r} has {len(tree.children)} "
                    "children; binarize first (BinarizeTreeTransformer, "
                    "or use vectorize() which binarizes internally)")
            for c in tree.children:
                self._post_order(c, out)
        out.append(tree)

    def vectorize_tree(self, tree: Tree) -> Tree:
        nodes: List[Tree] = []
        self._post_order(tree, nodes)
        # the tokens whose embeddings enter: leaves' and mixed nodes'
        # (token + children, e.g. post-CollapseUnaries)
        tokens = [n.value for n in nodes
                  if n.is_leaf() or n.value is not None]
        emb = torch.tensor(np.stack([self._leaf_vec(t) for t in tokens]),
                           device=self.device)
        vecs, k = [], 0
        at = {}
        for node in nodes:
            if node.is_leaf():
                v = emb[k]
                k += 1
            else:
                kids = [vecs[at[id(c)]] for c in node.children]
                v = kids[0] if len(kids) == 1 else self._compose(*kids)
                if node.value is not None:
                    v = self._compose(emb[k], v)
                    k += 1
            at[id(node)] = len(vecs)
            vecs.append(v)
        host = torch.stack(vecs).cpu().numpy()
        for node, row in zip(nodes, host):
            node.vector = row
        return tree

    def vectorize(self, text: str) -> List[Tree]:
        """Document → binarized, head-annotated, vectorized trees
        (ref: TreeVectorizer.getTreesWithLabels)."""
        out = []
        for tree in self._parser.trees_for(text):
            tree = self._binarizer.transform(tree)
            self._heads.annotate(tree)
            out.append(self.vectorize_tree(tree))
        return out
