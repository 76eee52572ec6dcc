"""Model zoo (so far the GPT decoder LM)."""

from deeplearning4j_tpu_torch.models.gpt import (  # noqa: F401
    gpt_decoder,
    gpt_tiny,
    greedy_generate,
)
