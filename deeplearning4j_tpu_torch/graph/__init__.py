"""Graph embeddings: in-memory graphs, random walks, DeepWalk, node2vec
(the JAX package's ``graph/``).

The counterpart of ``deeplearning4j-graph`` (ref:
deeplearning4j-graph/.../graph/Graph.java, iterator/RandomWalkIterator.java,
models/deepwalk/DeepWalk.java:95). The graph, the walks and the Huffman
codes are host numpy, draw for draw the JAX package's; the skip-gram
steps run on the trainer's device (the CUDA card unless ``device="cpu"``).
"""

from deeplearning4j_tpu_torch.graph.graph import Graph, Vertex, Edge  # noqa: F401
from deeplearning4j_tpu_torch.graph.walks import (  # noqa: F401
    RandomWalkIterator, WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphHuffman  # noqa: F401
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec, node2vec_walks  # noqa: F401
