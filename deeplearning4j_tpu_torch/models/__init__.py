"""Model zoo (so far the GPT decoder LM and the char-RNN LSTM)."""

from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm  # noqa: F401
from deeplearning4j_tpu_torch.models.gpt import (  # noqa: F401
    gpt_decoder,
    gpt_tiny,
    greedy_generate,
)
