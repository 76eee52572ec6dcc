"""Character-level LSTM (the JAX package's ``models/char_rnn.py``; BASELINE
config #4, the GravesLSTM char-RNN): stacked GravesLSTM layers and a
softmax ``RnnOutputLayer`` over the vocabulary, on the sequential
MultiLayerNetwork container, trained with its own settings: Adam at lr
1e-3, elementwise gradient clipping at 1.0 and truncated BPTT over
windows of ``tbptt_length`` steps."""

from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    LSTM, GravesLSTM, RnnOutputLayer,
)


def char_rnn_lstm(vocab_size: int, hidden: int = 256, layers: int = 2,
                  seed: int = 12345, learning_rate: float = 1e-3,
                  updater: str = "adam", tbptt_length: int = 50,
                  graves: bool = True,
                  dtype: str = "float32") -> MultiLayerConfiguration:
    """Input: one-hot characters ``[B, T, vocab_size]``; output: the
    per-timestep next-character distribution ``[B, T, vocab_size]``."""
    cell = GravesLSTM if graves else LSTM
    b = (NeuralNetConfiguration.builder()
         .seed(seed)
         .updater(updater, learning_rate=learning_rate)
         .weight_init("xavier")
         .gradient_normalization("clipelementwiseabsolutevalue", threshold=1.0)
         .dtype(dtype)
         .list())
    for _ in range(layers):
        b.layer(cell(n_out=hidden, activation="tanh"))
    b.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax",
                           loss="mcxent"))
    b.backprop_type("truncated_bptt", fwd=tbptt_length, bwd=tbptt_length)
    return b.set_input_type(InputType.recurrent(vocab_size)).build()
