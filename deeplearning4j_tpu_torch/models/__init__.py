"""Model zoo: the GPT decoder LM, the char-RNN LSTM, LeNet-5, VGG-16 and
ResNet-50."""

from deeplearning4j_tpu_torch.models.char_rnn import char_rnn_lstm  # noqa: F401
from deeplearning4j_tpu_torch.models.gpt import (  # noqa: F401
    gpt_decoder,
    gpt_tiny,
    greedy_generate,
)
from deeplearning4j_tpu_torch.models.lenet import lenet_mnist  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet import (  # noqa: F401
    resnet50,
    resnet_tiny,
)
from deeplearning4j_tpu_torch.models.vgg import (  # noqa: F401
    vgg16,
    vgg16_cifar10,
)
