"""Variational autoencoder (port of `paddle_tpu.models.vae`): MLP
encoder to (mu, logvar), the reparameterization z = mu + exp(logvar / 2)
* eps, MLP decoder to reconstruction logits; the loss is the negative
ELBO (binary CE + KL to N(0, I)).

`VAE.apply` takes the noise injected (`eps=`), or draws it from `rng` (a
torch.Generator on the input's device); with neither, z = mu.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from paddle_tpu_torch.nn.layers import Dense
from paddle_tpu_torch.nn.module import Layer, Sequential, ShapeSpec
from paddle_tpu_torch.ops import losses


class VAE(Layer):
    """apply(params, state, x, rng=..., eps=...) -> ((reconstruction
    logits, mu, logvar), {})."""

    def __init__(self, data_dim: int, latent_dim: int = 32,
                 hidden: Tuple[int, ...] = (256,), name: str = "vae"):
        self.data_dim, self.latent_dim = data_dim, latent_dim
        self.name = name
        enc = [Dense(h, activation="relu", name=f"enc{i}")
               for i, h in enumerate(hidden)]
        enc.append(Dense(2 * latent_dim, name="enc_out"))
        self.encoder = Sequential(enc)
        dec = [Dense(h, activation="relu", name=f"dec{i}")
               for i, h in enumerate(reversed(hidden))]
        dec.append(Dense(data_dim, name="dec_out"))
        self.decoder = Sequential(dec)

    def _init(self, rng, spec: ShapeSpec, _abstract: bool = False):
        z_spec = ShapeSpec((spec.shape[0], self.latent_dim), spec.dtype)
        if _abstract:
            _, _, out = self.decoder._init(None, z_spec, _abstract=True)
            return {}, {}, out
        enc_p, enc_s, _ = self.encoder._init(rng, spec)
        dec_p, dec_s, out = self.decoder._init(rng, z_spec)
        return ({"encoder": enc_p, "decoder": dec_p},
                {"encoder": enc_s, "decoder": dec_s}, out)

    def apply(self, params, state, x, *, training: bool = False, rng=None,
              eps: Optional[torch.Tensor] = None):
        return self._apply(params, state, x, training=training, rng=rng,
                           eps=eps)

    def _apply(self, params, state, x, *, training: bool, rng, eps=None):
        h, _ = self.encoder.apply(params["encoder"], state["encoder"], x,
                                  training=training, rng=rng)
        mu, logvar = torch.chunk(h, 2, dim=-1)
        if eps is None and rng is not None:
            eps = torch.randn(mu.shape, generator=rng, device=mu.device,
                              dtype=mu.dtype)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps.to(
            mu.dtype)
        logits, _ = self.decoder.apply(params["decoder"], state["decoder"],
                                       z, training=training, rng=rng)
        return (logits, mu, logvar), {}

    def decode(self, params, state, z):
        logits, _ = self.decoder.apply(params["decoder"], state["decoder"], z)
        return torch.sigmoid(logits)


def elbo_loss(outputs, x, *, kl_weight: float = 1.0):
    """Negative ELBO: BCE(reconstruction, x) + kl_weight * KL(q || N(0,
    I)), the batch mean."""
    logits, mu, logvar = outputs
    rec = torch.sum(losses.sigmoid_cross_entropy(logits, x), dim=-1)
    kl = 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar, dim=-1)
    return torch.mean(rec + kl_weight * kl)
