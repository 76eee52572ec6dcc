"""Data containers, iterators, record readers, dataset fetchers and the
streaming input pipeline (the JAX package's ``datasets/``)."""

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
from deeplearning4j_tpu_torch.datasets.pipeline import (  # noqa: F401
    IdxPair,
    StreamingInputPipeline,
    shard_sources,
)
from deeplearning4j_tpu_torch.datasets.iris import (  # noqa: F401
    IrisDataSetIterator,
    load_iris,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
    load_mnist,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    CifarDataSetIterator,
    CurvesDataSetIterator,
    LFWDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    LineRecordReader,
    RecordReader,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)
