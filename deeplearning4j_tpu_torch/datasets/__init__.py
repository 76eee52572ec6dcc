"""Data containers and iterators (the JAX package's ``datasets/``; so far
``DataSet``, ``MultiDataSet``, the iterators of ``iterator.py``, MNIST
and Iris)."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    AsyncDataSetIterator,
    DataSetIterator,
    DevicePrefetchIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.iris import (  # noqa: F401
    IrisDataSetIterator,
    load_iris,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
    load_mnist,
)
