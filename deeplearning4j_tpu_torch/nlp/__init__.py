"""NLP / embedding-model stack (the JAX package's ``nlp/``).

The counterpart of ``deeplearning4j-nlp-parent/deeplearning4j-nlp``
(ref: models/sequencevectors/SequenceVectors.java:187, models/word2vec/,
models/paragraphvectors/, models/glove/, text/).

The reference trains embeddings with `workers` hogwild threads doing
racy per-pair updates on a shared lookup table
(SequenceVectors.java:276-305). Here training is one step function on
the trainer's device (the CUDA card unless ``device="cpu"``) over a
*batch* of (center, context, negatives) index arrays: a gather, batched
products and a deterministic scatter of each touched row's summed
update. The text modules (tokenizers, annotators, the lattice tokenizer,
the tree parser, sentiment, the serializer) run on the host, as in the
JAX package. ``SparkSequenceVectors`` / ``SparkWord2Vec``
(``nlp/distributed.py``) train data-parallel over a ``torch.distributed``
group, each rank on its chunk of every batch, the touched rows' updates
combined across the ranks before they are applied.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    CommonPreprocessor,
    BasicLineIterator,
    CollectionSentenceIterator,
    LabelsSource,
    STOP_WORDS,
)
from deeplearning4j_tpu_torch.nlp.vocab import (  # noqa: F401
    VocabWord,
    VocabCache,
    VocabConstructor,
    build_huffman,
)
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable  # noqa: F401
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors  # noqa: F401
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer  # noqa: F401
from deeplearning4j_tpu_torch.nlp.distributed import (  # noqa: F401
    SparkSequenceVectors,
    SparkWord2Vec,
)
from deeplearning4j_tpu_torch.nlp.tokenization_ext import (  # noqa: F401
    JapaneseTokenizerFactory,
    KoreanTokenizerFactory,
    PosFilterTokenizerFactory,
    RegexSentenceIterator,
    pos_tag,
)
from deeplearning4j_tpu_torch.nlp.vectorizers import (  # noqa: F401
    BagOfWordsVectorizer,
    TfidfVectorizer,
)
from deeplearning4j_tpu_torch.nlp.lattice_tokenizer import (  # noqa: F401
    JapaneseLatticeTokenizer,
    JapaneseLatticeTokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.annotators import (  # noqa: F401
    AnnotatorPipeline,
    AnnotatorSentenceIterator,
    PosTokenizerFactory,
    StemmingPreprocessor,
    default_pipeline,
    lemmatize,
    porter_stem,
)
from deeplearning4j_tpu_torch.nlp.treeparser import (  # noqa: F401
    BinarizeTreeTransformer,
    CollapseUnaries,
    HeadWordFinder,
    Tree,
    TreeIterator,
    TreeParser,
    TreeVectorizer,
)
from deeplearning4j_tpu_torch.nlp.sentiment import SentimentAnalyzer  # noqa: F401
