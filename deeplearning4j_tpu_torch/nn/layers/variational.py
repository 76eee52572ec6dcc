"""Variational autoencoder layer (the JAX package's
``nn/layers/variational.py``).

Ref: nn/layers/variational/VariationalAutoencoder.java (1095 LoC) + conf
nn/conf/layers/variational/{VariationalAutoencoder,
GaussianReconstructionDistribution, BernoulliReconstructionDistribution}.java.

Structure matches the reference: encoder MLP -> (mean, log-variance) of
q(z|x) -> reparameterized sample -> decoder MLP -> reconstruction
distribution parameters. Pretraining minimizes the negative ELBO; as a
feed-forward layer inside a supervised net, ``apply`` outputs the q(z|x)
mean (what the reference's activate() does). The reference hand-derives
every gradient; here the ELBO is a scalar and autograd takes it. The
noise comes from ``draws.normal`` on the net's generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import draws
from deeplearning4j_tpu_torch.nn.layers.base import (
    BaseLayerConf, Params, register_layer,
)
from deeplearning4j_tpu_torch.ops.activations import get_activation

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Reconstruction distributions
# (ref: nn/conf/layers/variational/{GaussianReconstructionDistribution,
#  BernoulliReconstructionDistribution, ExponentialReconstructionDistribution,
#  CompositeReconstructionDistribution}.java)
# ---------------------------------------------------------------------------

class ReconstructionDistribution:
    """p(x|z) family: sizes its decoder-output parameters, scores data, and
    maps parameters to a mean reconstruction."""

    tag = "base"

    def param_size(self, data_size: int) -> int:
        raise NotImplementedError

    def log_prob(self, recon_params: Tensor, x: Tensor) -> Tensor:
        """log p(x|z) summed over features -> [batch]."""
        raise NotImplementedError

    def mean(self, recon_params: Tensor) -> Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@dist": self.tag}

    @staticmethod
    def from_dict(d) -> "ReconstructionDistribution":
        if isinstance(d, str):
            return _named_distribution(d)
        tag = d["@dist"]
        if tag == "composite":
            return CompositeReconstructionDistribution([
                (int(s), ReconstructionDistribution.from_dict(sub))
                for s, sub in d["components"]])
        return _named_distribution(tag)


class GaussianReconstructionDistribution(ReconstructionDistribution):
    """mean + log-variance per visible unit
    (ref: GaussianReconstructionDistribution.java)."""

    tag = "gaussian"

    def param_size(self, data_size):
        return 2 * data_size

    def log_prob(self, recon_params, x):
        mean, logvar = torch.chunk(recon_params, 2, dim=-1)
        lp = -0.5 * (math.log(2 * math.pi) + logvar
                     + (x - mean) ** 2 / torch.exp(logvar))
        return lp.sum(-1)

    def mean(self, recon_params):
        return torch.chunk(recon_params, 2, dim=-1)[0]


class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """one logit per visible unit (ref: Bernoulli...Distribution.java)."""

    tag = "bernoulli"

    def param_size(self, data_size):
        return data_size

    def log_prob(self, recon_params, x):
        z = recon_params
        return (x * F.logsigmoid(z) + (1 - x) * F.logsigmoid(-z)).sum(-1)

    def mean(self, recon_params):
        return torch.sigmoid(recon_params)


class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """p(x) = lambda exp(-lambda x) with gamma = log(lambda) as the
    network output: log p = gamma - x * exp(gamma)
    (ref: ExponentialReconstructionDistribution.java: parameterized in
    gamma for unconstrained optimization; mean = 1/lambda)."""

    tag = "exponential"

    def param_size(self, data_size):
        return data_size

    def log_prob(self, recon_params, x):
        gamma = recon_params
        return (gamma - x * torch.exp(gamma)).sum(-1)

    def mean(self, recon_params):
        return torch.exp(-recon_params)  # 1 / lambda


class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Different distributions over slices of the data vector, e.g.
    [0:784] bernoulli pixels + [784:794] gaussian extras
    (ref: CompositeReconstructionDistribution.java: distributionSizes +
    per-slice parameter offsets)."""

    tag = "composite"

    def __init__(self, components):
        """components: list of (data_size, ReconstructionDistribution)."""
        self.components = [(int(s), d if isinstance(
                                d, ReconstructionDistribution)
                            else _named_distribution(d))
                           for s, d in components]

    def param_size(self, data_size):
        total_data = sum(s for s, _ in self.components)
        if total_data != data_size:
            raise ValueError(
                f"Composite distribution covers {total_data} dims but the "
                f"data has {data_size}")
        return sum(d.param_size(s) for s, d in self.components)

    def log_prob(self, recon_params, x):
        out = 0.0
        data_off = param_off = 0
        for size, dist in self.components:
            psize = dist.param_size(size)
            out = out + dist.log_prob(
                recon_params[..., param_off:param_off + psize],
                x[..., data_off:data_off + size])
            data_off += size
            param_off += psize
        return out

    def mean(self, recon_params):
        outs = []
        param_off = 0
        for size, dist in self.components:
            psize = dist.param_size(size)
            outs.append(dist.mean(
                recon_params[..., param_off:param_off + psize]))
            param_off += psize
        return torch.cat(outs, dim=-1)

    def to_dict(self):
        return {"@dist": "composite",
                "components": [[s, d.to_dict()] for s, d in self.components]}


_NAMED = {
    "gaussian": GaussianReconstructionDistribution,
    "bernoulli": BernoulliReconstructionDistribution,
    "exponential": ExponentialReconstructionDistribution,
}


def _named_distribution(name: str) -> ReconstructionDistribution:
    if name not in _NAMED:
        raise ValueError(f"Unknown reconstruction distribution {name!r}; "
                         f"available: {sorted(_NAMED)} or a "
                         "CompositeReconstructionDistribution")
    return _NAMED[name]()


@register_layer
@dataclass
class VariationalAutoencoder(BaseLayerConf):
    n_out: int = 0                                # size of latent z
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    # "gaussian" | "bernoulli" | "exponential" | a ReconstructionDistribution
    # instance (e.g. CompositeReconstructionDistribution)
    reconstruction_distribution: object = "gaussian"
    pzx_activation: str = "identity"               # activation on q(z|x) mean
    num_samples: int = 1

    def set_n_in(self, in_type: InputType) -> None:
        self.n_in = in_type.flat_size()

    def infer_output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def _dist(self) -> ReconstructionDistribution:
        rd = self.reconstruction_distribution
        return rd if isinstance(rd, ReconstructionDistribution) \
            else _named_distribution(rd)

    # serde: the distribution may be an object, encoded by its dict form
    def to_dict(self) -> dict:
        d = super().to_dict()
        rd = self.reconstruction_distribution
        if isinstance(rd, ReconstructionDistribution):
            d["reconstruction_distribution"] = rd.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "VariationalAutoencoder":
        d = dict(d)
        rd = d.get("reconstruction_distribution")
        if isinstance(rd, dict):
            d["reconstruction_distribution"] = \
                ReconstructionDistribution.from_dict(rd)
        return super().from_dict(d)

    # ---- param layout: e{i}W/e{i}b encoder stack, zMeanW/b, zLogVarW/b,
    #      d{i}W/d{i}b decoder stack, outW/outb (reconstruction params) ----
    def param_order(self) -> List[str]:
        names = []
        for i in range(len(self.encoder_layer_sizes)):
            names += [f"e{i}W", f"e{i}b"]
        names += ["zMeanW", "zMeanb", "zLogVarW", "zLogVarb"]
        for i in range(len(self.decoder_layer_sizes)):
            names += [f"d{i}W", f"d{i}b"]
        names += ["outW", "outb"]
        return names

    def _recon_param_size(self) -> int:
        return self._dist().param_size(self.n_in)

    def init_params(self, gen, dtype=torch.float32) -> Params:
        p: Params = {}

        def dense(prefix, n_in, n_out):
            p[f"{prefix}W"] = self._init_w(gen, (n_in, n_out), n_in, n_out,
                                           dtype)
            p[f"{prefix}b"] = self._init_b((n_out,), dtype)

        last = self.n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            dense(f"e{i}", last, h)
            last = h
        dense("zMean", last, self.n_out)
        dense("zLogVar", last, self.n_out)
        last = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            dense(f"d{i}", last, h)
            last = h
        dense("out", last, self._recon_param_size())
        return {k: p[k] for k in self.param_order()}

    # ------------------------------------------------------------- components
    def encode(self, params: Params, x: Tensor) -> Tuple[Tensor, Tensor]:
        act = get_activation(self.activation)
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"e{i}W"] + params[f"e{i}b"])
        mean = get_activation(self.pzx_activation)(
            h @ params["zMeanW"] + params["zMeanb"])
        logvar = h @ params["zLogVarW"] + params["zLogVarb"]
        return mean, logvar

    def decode(self, params: Params, z: Tensor) -> Tensor:
        """The reconstruction distribution's parameters (pre-activation)."""
        act = get_activation(self.activation)
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"d{i}W"] + params[f"d{i}b"])
        return h @ params["outW"] + params["outb"]

    def _recon_log_prob(self, recon_params: Tensor, x: Tensor) -> Tensor:
        """log p(x|z), summed over features -> [batch]."""
        return self._dist().log_prob(recon_params, x)

    def _sample_log_probs(self, params, x, mean, logvar, rng, n):
        """log p(x|z) of ``n`` reparameterized draws z, in draw order."""
        out = []
        for _ in range(n):
            eps = draws.normal(rng, mean.shape, mean.dtype, mean.device)
            z = mean + torch.exp(0.5 * logvar) * eps
            out.append(self._recon_log_prob(self.decode(params, z), x))
        return out

    # ---------------------------------------------------------------- forward
    def apply(self, params, x, *, state, train=False, rng=None, mask=None):
        x = self._dropout_input(x, train, rng)
        mean, _ = self.encode(params, x)
        return mean, state

    def pretrain_loss(self, params: Params, x: Tensor, *, rng) -> Tensor:
        """Negative ELBO (ref: VariationalAutoencoder.
        computeGradientAndScore), averaged over ``num_samples``
        reparameterized draws from ``rng``."""
        mean, logvar = self.encode(params, x)
        kl = -0.5 * (1 + logvar - mean ** 2 - torch.exp(logvar)).sum(-1)
        total_recon = 0.0
        for lp in self._sample_log_probs(params, x, mean, logvar, rng,
                                         self.num_samples):
            total_recon = total_recon + lp
        return (kl - total_recon / self.num_samples).mean()

    def reconstruction_probability(self, params, x, *, rng, num_samples=5):
        """Monte-carlo estimate of log p(x), the reference's anomaly score
        (ref: VariationalAutoencoder.reconstructionLogProbability)."""
        mean, logvar = self.encode(params, x)
        log_ps = self._sample_log_probs(params, x, mean, logvar, rng,
                                        num_samples)
        return (torch.logsumexp(torch.stack(log_ps), dim=0)
                - math.log(float(num_samples)))

    def generate(self, params, z):
        """Decode latent samples to reconstruction-distribution means."""
        return self._dist().mean(self.decode(params, z))
