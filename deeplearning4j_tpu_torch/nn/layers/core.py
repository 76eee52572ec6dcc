"""Feed-forward layers (the JAX package's ``nn/layers/core.py``): Dense,
Output, Loss, Activation, Dropout, Embedding, the pretraining layers
AutoEncoder and RBM (whose random draws go through ``draws``), and
CenterLossOutput.

Loss heads compute their loss from the layer's *input* (``compute_loss``),
as the containers hand it over; dropout never fires inside a loss.

Under a model axis the Dense family consumes its ``W`` column shard
(``parallel/tensor.column_linear``): the product on this rank's columns,
the all-gather of the last axis, then the replicated bias and the
activation (an output layer's softmax too) on the whole activation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import draws
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.losses import get_loss, promote_loss_dtype


def _linear(x, params, n_out):
    from deeplearning4j_tpu_torch.parallel.tensor import column_linear
    return column_linear(x, params["W"], params["b"], n_out)


@register_layer
@dataclass
class DenseLayer(BaseLayerConf):
    """Fully connected: act(x @ W + b), W ``[n_in, n_out]``."""
    n_out: int = 0

    sequence_local = True

    def column_parallel_params(self, n_model: int) -> set:
        return {"W"}

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
        }

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        return get_activation(self.activation)(
            _linear(x, params, self.n_out)), state


@register_layer
@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (DL4J's OutputLayer)."""
    loss: str = "mcxent"

    def compute_loss(self, params, x, labels, *, mask=None,
                     average: bool = True):
        """The mean per-example loss (or the ``[B]`` vector with
        ``average=False``) from this layer's input ``x``."""
        preout = _linear(x, params, self.n_out)
        preout, labels = promote_loss_dtype(preout, labels)
        if preout.shape != labels.shape:
            raise ValueError(
                f"OutputLayer: network output shape {tuple(preout.shape)} "
                f"!= labels shape {tuple(labels.shape)}. For per-timestep "
                "targets use RnnOutputLayer; for sequence classification "
                "pool time first (GlobalPoolingLayer).")
        per_ex = get_loss(self.loss)(labels, preout, self.activation, mask)
        return per_ex.mean() if average else per_ex


@register_layer
@dataclass
class LossLayer(BaseLayerConf):
    """Loss-only head without params: the activation of its input is the
    network's output."""
    loss: str = "mcxent"

    sequence_local = True

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return get_activation(self.activation)(x), state

    def compute_loss(self, params, x, labels, *, mask=None,
                     average: bool = True):
        x, labels = promote_loss_dtype(x, labels)
        per_ex = get_loss(self.loss)(labels, x, self.activation, mask)
        return per_ex.mean() if average else per_ex


@register_layer
@dataclass
class ActivationLayer(BaseLayerConf):
    """The activation alone, without params."""

    sequence_local = True

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return get_activation(self.activation)(x), state


@register_layer
@dataclass
class DropoutLayer(BaseLayerConf):
    """Dropout alone; ``dropout`` holds DL4J's *retain* probability."""

    sequence_local = True

    def infer_output_type(self, in_type: InputType) -> InputType:
        return in_type

    def param_order(self) -> List[str]:
        return []

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        return self._dropout_input(x, train, rng), state


@register_layer
@dataclass
class EmbeddingLayer(BaseLayerConf):
    """Index -> row of W, plus b: the one-hot product done as a gather.
    The input holds the indices, ``[B]`` or ``[B, 1]``."""
    n_out: int = 0

    sequence_local = True

    def column_parallel_params(self, n_model: int) -> set:
        return {"W"}

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
        }

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        out = params["W"][idx]
        if out.shape[-1] != self.n_out:     # this rank's column shard
            from deeplearning4j_tpu_torch.parallel.mesh import (
                active_model_context,
            )
            out = active_model_context().gather_model(out)
        out = out + params["b"]
        return get_activation(self.activation)(out), state


@register_layer
@dataclass
class AutoEncoder(BaseLayerConf):
    """Denoising autoencoder (ref: nn/layers/feedforward/autoencoder/
    AutoEncoder.java). Params: W (tied decode via W^T), b (hidden), vb
    (visible), PretrainParamInitializer's W/b/vb contract."""
    n_out: int = 0
    corruption_level: float = 0.3
    loss: str = "mse"

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def param_order(self) -> List[str]:
        return ["W", "b", "vb"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
            "vb": self._init_b((self.n_in,), dtype),
        }

    def encode(self, params, x):
        return get_activation(self.activation)(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return get_activation(self.activation)(h @ params["W"].T
                                               + params["vb"])

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, *, rng):
        """Denoising reconstruction loss for layerwise pretraining (ref:
        AutoEncoder.computeGradientAndScore): the input corrupted by a
        keep-mask drawn from ``rng`` (``draws.keep_mask``), encoded,
        decoded and held to the clean input."""
        if self.corruption_level > 0 and rng is not None:
            keep = draws.keep_mask(rng, 1.0 - self.corruption_level,
                                   x.shape, x.device)
            corrupted = torch.where(keep, x, 0.0)
        else:
            corrupted = x
        recon = self.decode(params, self.encode(params, corrupted))
        return ((recon - x) ** 2).sum(-1).mean()


@register_layer
@dataclass
class RBM(BaseLayerConf):
    """Restricted Boltzmann machine with CD-k pretraining (ref:
    nn/layers/feedforward/rbm/RBM.java; conf nn/conf/layers/RBM.java,
    HiddenUnit/VisibleUnit BINARY|GAUSSIAN). The forward is propup
    (sigmoid, or identity for non-binary hidden units), used as a
    feed-forward layer after pretraining, as the reference does."""
    n_out: int = 0
    hidden_unit: str = "binary"    # binary | gaussian | relu
    visible_unit: str = "binary"
    k: int = 1                      # CD-k steps

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def param_order(self) -> List[str]:
        return ["W", "b", "vb"]

    def init_params(self, gen, dtype=torch.float32) -> Params:
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                              self.n_out, dtype),
            "b": self._init_b((self.n_out,), dtype),
            "vb": self._init_b((self.n_in,), dtype),
        }

    def _hid_mean(self, params, v):
        pre = v @ params["W"] + params["b"]
        return torch.sigmoid(pre) if self.hidden_unit == "binary" else pre

    def _vis_mean(self, params, h):
        pre = h @ params["W"].T + params["vb"]
        return torch.sigmoid(pre) if self.visible_unit == "binary" else pre

    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        return self._hid_mean(params, x), state

    def cd_gradients(self, params, v0, *, rng) -> Tuple[Params, torch.Tensor]:
        """One CD-k estimate: (gradients, reconstruction error). Hand-coded
        because contrastive divergence is not an autodiff loss (ref:
        RBM.computeGradientAndScore); binary hidden units are sampled
        against ``draws.uniform`` from ``rng``, one draw a CD step."""
        h0 = self._hid_mean(params, v0)
        hk_mean, vk = h0, v0
        for _ in range(self.k):
            if self.hidden_unit == "binary":
                u = draws.uniform(rng, hk_mean.shape, hk_mean.dtype,
                                  hk_mean.device)
                h_sample = (u < hk_mean).to(v0.dtype)
            else:
                h_sample = hk_mean
            vk = self._vis_mean(params, h_sample)
            hk_mean = self._hid_mean(params, vk)
        n = v0.shape[0]
        grads = {
            "W": -(v0.T @ h0 - vk.T @ hk_mean) / n,
            "b": -(h0 - hk_mean).mean(0),
            "vb": -(v0 - vk).mean(0),
        }
        err = ((v0 - vk) ** 2).sum(-1).mean()
        return grads, err


@register_layer
@dataclass
class CenterLossOutputLayer(OutputLayer):
    """Output layer with an auxiliary center loss: ``cL`` ``[n_out, n_in]``
    holds one center per class, is not regularized, takes no gradient
    (the loss stops it) and moves by an exponential moving average
    outside the gradient step (``updated_centers``, which
    ``MultiLayerNetwork`` applies after each update); ``lambda_`` weights
    the squared distance of the features to their class's center."""
    alpha: float = 0.05
    lambda_: float = 2e-4

    def param_order(self) -> List[str]:
        return ["W", "b", "cL"]

    def column_parallel_params(self, n_model: int) -> set:
        return set()

    def init_params(self, gen, dtype=torch.float32) -> Params:
        p = super().init_params(gen, dtype)
        p["cL"] = torch.zeros((self.n_out, self.n_in), dtype=dtype)
        return p

    def regularization(self):
        reg = super().regularization()
        reg["cL"] = (0.0, 0.0)
        return reg

    def compute_loss(self, params, x, labels, *, mask=None,
                     average: bool = True):
        preout = x @ params["W"] + params["b"]
        per_ex = get_loss(self.loss)(labels, preout, self.activation, mask)
        centers = labels @ params["cL"].detach()         # [B, n_in]
        per_ex = per_ex + 0.5 * self.lambda_ * ((x - centers) ** 2).sum(-1)
        return per_ex.mean() if average else per_ex

    def updated_centers(self, params, x, labels):
        """The EMA of the centers toward this batch's class means; a class
        absent from the batch keeps its center."""
        present = labels.sum(dim=0)
        batch_centers = (labels.T @ x) / present.clamp(min=1.0)[:, None]
        cL = params["cL"]
        return torch.where((present > 0)[:, None],
                           (1 - self.alpha) * cL
                           + self.alpha * batch_centers, cL)
