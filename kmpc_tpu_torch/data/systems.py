"""Dynamical-system environments (port of kmpc_tpu/data/systems.py).

Each system is a vector field ``dynamics(x)`` over the trailing axis of a
batch of states and a law of random initial states, discretised by RK4.
Initial states are drawn on the device of the ``torch.Generator`` the
caller passes, so a training step synthesises its batch without the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from kmpc_tpu_torch.config import Config


def integrate_euler(x: torch.Tensor, dt: float, dynamics_fn: Callable
                    ) -> torch.Tensor:
    """One explicit-Euler step."""
    return x + dt * dynamics_fn(x)


def integrate_rk4(x: torch.Tensor, dt: float, dynamics_fn: Callable
                  ) -> torch.Tensor:
    """One classic fourth-order Runge-Kutta step."""
    k1 = dynamics_fn(x)
    k2 = dynamics_fn(x + 0.5 * dt * k1)
    k3 = dynamics_fn(x + 0.5 * dt * k2)
    k4 = dynamics_fn(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    """A constant on ``like``'s device, copied without waiting for the
    device (a blocking copy would synchronise the host in a training
    step)."""
    return torch.tensor(values, dtype=like.dtype).to(like.device,
                                                     non_blocking=True)


def _uniform(lo: Tuple[float, ...], hi: Tuple[float, ...]):
    """Initial states uniform in the box [lo, hi] per coordinate."""

    def sample(generator: torch.Generator, batch_size: int) -> torch.Tensor:
        u = torch.rand(batch_size, len(lo), generator=generator,
                       device=generator.device)
        lo_t = _const(lo, u)
        return lo_t + u * (_const(hi, u) - lo_t)

    return sample


@dataclass(frozen=True)
class DynamicalSystem:
    """A continuous-time autonomous system with an RK4 step of ``dt``."""

    name: str
    dt: float
    observation_size: int
    dynamics: Callable[[torch.Tensor], torch.Tensor]
    sample_init: Callable[[torch.Generator, int], torch.Tensor]

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """Advance one dt with RK4 (batched over leading axes)."""
        return integrate_rk4(x, self.dt, self.dynamics)

    def reset(self, generator: torch.Generator,
              batch_size: Optional[int] = None) -> torch.Tensor:
        """Random initial states [B, D] on the generator's device; one
        state [D] without ``batch_size``."""
        x = self.sample_init(generator, 1 if batch_size is None else batch_size)
        return x[0] if batch_size is None else x

    def trajectory(self, x0: torch.Tensor, length: int) -> torch.Tensor:
        """States x_1..x_length from x0: [length, ...] (x0 excluded)."""
        traj, x = [], x0
        for _ in range(length):
            x = self.step(x)
            traj.append(x)
        return torch.stack(traj)

    def sequence_batch(self, generator: torch.Generator, batch_size: int,
                       window_length: int) -> torch.Tensor:
        """Windows [B, T+1, D] from random initial states, x0 included."""
        x0 = self.reset(generator, batch_size)
        seq = torch.cat([x0[None], self.trajectory(x0, window_length)])
        return seq.transpose(0, 1)


def make_pendulum(cfg: Config) -> DynamicalSystem:
    """Free pendulum: x1'' = -(g/L) sin(x1)."""
    g_over_l = 9.81 / 1.0

    def dynamics(x):
        x1, x2 = x[..., 0], x[..., 1]
        return torch.stack([x2, -g_over_l * torch.sin(x1)], dim=-1)

    return DynamicalSystem("pendulum", cfg.ENV.PENDULUM.DT, 2, dynamics,
                           _uniform((-math.pi, -2.0), (math.pi, 2.0)))


def make_duffing(cfg: Config) -> DynamicalSystem:
    """Unforced Duffing oscillator: x'' = x - x^3."""

    def dynamics(x):
        x1, x2 = x[..., 0], x[..., 1]
        return torch.stack([x2, x1 - x1 ** 3], dim=-1)

    return DynamicalSystem("duffing", cfg.ENV.DUFFING.DT, 2, dynamics,
                           _uniform((-1.5, -1.0), (1.5, 1.0)))


def make_lotka_volterra(cfg: Config) -> DynamicalSystem:
    """Predator-prey, alpha = beta = gamma = delta = 0.2."""
    a = b = g = d = 0.2

    def dynamics(x):
        prey, pred = x[..., 0], x[..., 1]
        return torch.stack([a * prey - b * prey * pred,
                            d * prey * pred - g * pred], dim=-1)

    return DynamicalSystem("lotka_volterra", cfg.ENV.LOTKA_VOLTERRA.DT, 2,
                           dynamics, _uniform((0.02, 0.02), (3.0, 3.0)))


def make_lorenz63(cfg: Config) -> DynamicalSystem:
    """Lorenz '63, sigma = 10, rho = 28, beta = 8/3; initial states
    (0, 1, 1.05) plus a standard normal draw."""
    sigma, rho, beta = 10.0, 28.0, 8.0 / 3.0

    def dynamics(s):
        x, y, z = s[..., 0], s[..., 1], s[..., 2]
        return torch.stack([sigma * (y - x), x * (rho - z) - y,
                            x * y - beta * z], dim=-1)

    def sample_init(generator, batch_size):
        noise = torch.randn(batch_size, 3, generator=generator,
                            device=generator.device)
        return _const((0.0, 1.0, 1.05), noise) + noise

    return DynamicalSystem("lorenz63", cfg.ENV.LORENZ63.DT, 3, dynamics,
                           sample_init)


def make_parabolic(cfg: Config) -> DynamicalSystem:
    """Parabolic attractor x2 -> x1^2."""
    lam, mu = cfg.ENV.PARABOLIC.LAMBDA, cfg.ENV.PARABOLIC.MU

    def dynamics(x):
        x1, x2 = x[..., 0], x[..., 1]
        return torch.stack([mu * x1, lam * (x2 - x1 ** 2)], dim=-1)

    return DynamicalSystem("parabolic", cfg.ENV.PARABOLIC.DT, 2, dynamics,
                           _uniform((-1.0, -1.0), (1.0, 1.0)))


# Equilibria of the Lyapunov multi-attractor field.
_LYAPUNOV_POINTS = (
    (-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0), (1.0, 1.0),
    (0.0, 0.0),
    (-1.0, -2.0), (1.0, -2.0), (-1.0, 2.0), (1.0, 2.0),
    (-2.0, -1.0), (2.0, -1.0), (-2.0, 1.0), (2.0, 1.0),
)


# _LYAPUNOV_POINTS as the origin, then three quads (a, b, c, d): b is a
# mirrored in x, c is a mirrored in y, d is both.
_LYAPUNOV_QUADS = (4, 0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12)


def _quad_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the points of t [..., 13, 2] (in _LYAPUNOV_QUADS'
    order), each quad as (a + b) + (c + d): on an axis of the field's
    symmetry the mirrored terms cancel exactly, so a state on it stays on
    it as the field says."""
    q = t[..., 1:, :].unflatten(-2, (3, 4))
    quads = (q[..., 0, :] + q[..., 1, :]) + (q[..., 2, :] + q[..., 3, :])
    return t[..., 0, :] + ((quads[..., 0, :] + quads[..., 1, :])
                           + quads[..., 2, :])


def make_lyapunov(cfg: Config) -> DynamicalSystem:
    """Multi-attractor field from Gaussian bumps around _LYAPUNOV_POINTS."""
    sigma2 = float(cfg.ENV.LYAPUNOV.SIGMA) ** 2
    points = tuple(_LYAPUNOV_POINTS[i] for i in _LYAPUNOV_QUADS)

    def dynamics(x):
        diff = x[..., None, :] - _const(points, x)      # [..., M, 2]
        r2 = torch.sum(diff * diff, dim=-1)              # [..., M]
        normx2 = torch.sum(x * x, dim=-1, keepdim=True)  # [..., 1]
        bump = torch.exp(-r2 / sigma2)
        term1 = (-2.0 / sigma2) * _quad_sum((normx2 * bump)[..., None] * diff)
        term2 = -_quad_sum(bump[..., None] * diff)
        return term1 + term2

    return DynamicalSystem("lyapunov", cfg.ENV.LYAPUNOV.DT, 2, dynamics,
                           _uniform((-2.5, -2.5), (2.5, 2.5)))


_SYSTEM_REGISTRY = {
    "pendulum": make_pendulum,
    "duffing": make_duffing,
    "lotka_volterra": make_lotka_volterra,
    "lorenz63": make_lorenz63,
    "parabolic": make_parabolic,
    "lyapunov": make_lyapunov,
}


def make_system(cfg: Config, name: Optional[str] = None) -> DynamicalSystem:
    """The system ``name`` (default ``cfg.ENV.ENV_NAME``)."""
    env_name = name if name is not None else cfg.ENV.ENV_NAME
    if env_name not in _SYSTEM_REGISTRY:
        raise ValueError(f"Unknown environment '{env_name}'. Available: "
                         f"{list(_SYSTEM_REGISTRY.keys())}")
    return _SYSTEM_REGISTRY[env_name](cfg)


def system_dt(cfg: Config, name: Optional[str] = None) -> float:
    """The step of a system from the config; 0.01 for an unknown name."""
    env_name = (name if name is not None else cfg.ENV.ENV_NAME).lower()
    table = {
        "duffing": cfg.ENV.DUFFING.DT,
        "pendulum": cfg.ENV.PENDULUM.DT,
        "lotka_volterra": cfg.ENV.LOTKA_VOLTERRA.DT,
        "lorenz63": cfg.ENV.LORENZ63.DT,
        "parabolic": cfg.ENV.PARABOLIC.DT,
        "lyapunov": cfg.ENV.LYAPUNOV.DT,
    }
    return table.get(env_name, 0.01)
