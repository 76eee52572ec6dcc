"""Clustering + nearest-neighbor + t-SNE (the JAX package's
``clustering/``).

The counterpart of deeplearning4j-core/.../clustering (K-means, KD-tree,
VP-tree) and plot/BarnesHutTsne.java. The reference's spatial trees make
neighbor queries sub-quadratic on a CPU; here, as in the JAX package,
``VPTree`` and t-SNE compute dense batched distance products on the
device (the CUDA card unless ``device="cpu"``), ``KMeansClustering``
runs its Lloyd steps there, and ``KDTree`` stays a host tree.
"""

from deeplearning4j_tpu_torch.clustering.kmeans import (  # noqa: F401
    KMeansClustering, Cluster, ClusterSet, Point,
)
from deeplearning4j_tpu_torch.clustering.knn import VPTree, KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.tsne import Tsne  # noqa: F401
