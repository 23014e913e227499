"""GAN: a generator and a discriminator trained adversarially with two
optimizers (port of `paddle_tpu.models.gan`). Both nets are ordinary
`nn` Layers; `GANTrainer.train_step` runs one discriminator update on
(real, fake), then one generator update, each with its own adam.

The discriminator's update reads the shared step counter and bumps it,
so the generator's update (adam's bias correction) reads the bumped
value, as in the JAX package. Latent noise is drawn from a
torch.Generator, or injected (`z=`): `jax.random` and torch never draw
alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.nn.initializers import as_rng
from paddle_tpu_torch.nn.layers import Dense
from paddle_tpu_torch.nn.module import Layer, Sequential, ShapeSpec
from paddle_tpu_torch.ops import losses
from paddle_tpu_torch.optim import optimizers as optim


def mlp_generator(out_dim: int, noise_dim: int = 64,
                  hidden: Tuple[int, ...] = (256, 256)) -> Layer:
    """Noise [B, noise_dim] -> a sample [B, out_dim] in (0, 1)."""
    layers = [Dense(h, activation="relu", name=f"g_fc{i}")
              for i, h in enumerate(hidden)]
    layers.append(Dense(out_dim, activation="sigmoid", name="g_out"))
    return Sequential(layers)


def mlp_discriminator(hidden: Tuple[int, ...] = (256, 256)) -> Layer:
    """A sample [B, D] -> a logit [B, 1] (real vs fake)."""
    layers = [Dense(h, activation="relu", name=f"d_fc{i}")
              for i, h in enumerate(hidden)]
    layers.append(Dense(1, name="d_out"))
    return Sequential(layers)


@dataclasses.dataclass
class GANState:
    g_params: Any
    g_state: Any
    g_opt: Any
    d_params: Any
    d_state: Any
    d_opt: Any
    step: Any = 0      # an int32 0-d tensor on the params' device


def _grads(loss_fn, params):
    """(loss, grads with params' tree) of loss_fn(tracked params)."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = loss_fn(tracked)
        got = iter(torch.autograd.grad(loss, tree_leaves(tracked)))
    return loss.detach(), tree_map(lambda _: next(got), params)


class GANTrainer:
    """Alternating adversarial trainer: per step, a discriminator update
    on real and generated samples, then a generator update (the
    non-saturating loss)."""

    def __init__(self, generator: Layer, discriminator: Layer,
                 data_dim: int, noise_dim: int = 64,
                 g_optimizer=None, d_optimizer=None):
        self.g, self.d = generator, discriminator
        self.data_dim, self.noise_dim = data_dim, noise_dim
        self.g_optim = g_optimizer or optim.adam(2e-4, beta1=0.5)
        self.d_optim = d_optimizer or optim.adam(2e-4, beta1=0.5)

    def init_state(self, rng, batch_size: int, *, device=None) -> GANState:
        """Both nets' params and optimizer states on `device` (None ->
        cuda); rng an int seed, a numpy RandomState or a CPU
        torch.Generator (the generator's params are drawn first)."""
        dev = resolve_device(device)
        rng = as_rng(rng)
        g_params, g_state = self.g.init(
            rng, ShapeSpec((batch_size, self.noise_dim)), device=dev)
        d_params, d_state = self.d.init(
            rng, ShapeSpec((batch_size, self.data_dim)), device=dev)
        return GANState(g_params, g_state, self.g_optim.init(g_params),
                        d_params, d_state, self.d_optim.init(d_params),
                        torch.zeros((), dtype=torch.int32, device=dev))

    def _noise(self, generator, n, device):
        return torch.randn((n, self.noise_dim), generator=generator,
                           device=device)

    def _gen(self, g_params, g_state, z):
        fake, _ = self.g.apply(g_params, g_state, z, training=True)
        return fake

    def _logit(self, d_params, d_state, x):
        logit, _ = self.d.apply(d_params, d_state, x, training=True)
        return logit[:, 0]

    def _d_step(self, state: GANState, real, z):
        with torch.no_grad():
            fake = self._gen(state.g_params, state.g_state, z)
        n = real.shape[0]

        def loss_fn(d_params):
            lr = losses.sigmoid_cross_entropy(
                self._logit(d_params, state.d_state, real),
                real.new_ones(n))
            lf = losses.sigmoid_cross_entropy(
                self._logit(d_params, state.d_state, fake),
                real.new_zeros(n))
            return torch.mean(lr) + torch.mean(lf)

        loss, grads = _grads(loss_fn, state.d_params)
        d_params, d_opt = self.d_optim.update(grads, state.d_opt,
                                              state.d_params, state.step)
        return dataclasses.replace(state, d_params=d_params, d_opt=d_opt,
                                   step=state.step + 1), loss

    def _g_step(self, state: GANState, z):
        def loss_fn(g_params):
            logit = self._logit(state.d_params, state.d_state,
                                self._gen(g_params, state.g_state, z))
            return torch.mean(losses.sigmoid_cross_entropy(
                logit, torch.ones_like(logit)))

        loss, grads = _grads(loss_fn, state.g_params)
        g_params, g_opt = self.g_optim.update(grads, state.g_opt,
                                              state.g_params, state.step)
        return dataclasses.replace(state, g_params=g_params,
                                   g_opt=g_opt), loss

    def train_step(self, state: GANState, real,
                   generator: Optional[torch.Generator] = None, *, z=None):
        """One alternation: the discriminator's update, then the
        generator's. z: the two latent batches (z_d, z_g), each [B,
        noise_dim], injected; else both drawn from `generator` on real's
        device. The params and optimizer states update in place.
        Returns (state, d_loss, g_loss)."""
        n = real.shape[0]
        if z is None:
            z = (self._noise(generator, n, real.device),
                 self._noise(generator, n, real.device))
        z_d, z_g = (t.to(device=real.device, dtype=real.dtype) for t in z)
        state, d_loss = self._d_step(state, real, z_d)
        state, g_loss = self._g_step(state, z_g)
        return state, d_loss, g_loss

    def sample(self, state: GANState, generator: Optional[torch.Generator]
               = None, n: int = 1, *, z=None):
        """n generated samples [n, data_dim] (z [n, noise_dim] injected,
        or drawn from `generator`)."""
        dev = state.step.device
        if z is None:
            z = self._noise(generator, n, dev)
        with torch.no_grad():
            return self._gen(state.g_params, state.g_state, z.to(dev))
