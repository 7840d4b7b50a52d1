"""Koopman autoencoders GenericKM / SparseKM and LISTAKM as an ``nn.Module``.

Port of kmpc_tpu/models/koopman.py. GenericKM: an MLP encoder, an MLP decoder and a learnable Koopman matrix K
applied as ``z @ K`` (identity at init), with the latent normalization
``id`` or ``ball``. LISTAKM: a LISTA sparse encoder, a dictionary decoder
(``dict`` [z, x], its rows normalised) and K without normalization.
Parameter names follow the original PyTorch KoopmanMachine state dict
(``encoder.network.*``, ``decoder.network.*``, ``dict``, ``lista.*``,
``kmat``). The losses and rollouts are the training objectives; the
Koopman spectrum is computed on the host (:func:`spectral_metrics`).

``compute_dtype="bfloat16"`` is kmpc_tpu's mixed precision: every encoder,
decoder and ``z @ K`` product takes bfloat16 operands and accumulates in
float32 (``models/mlp.py`` :func:`matmul_f32`), activations and latents
ride bfloat16, the losses reduce in float32, and the parameters (and
AdamW's state) stay float32. The continuous-time path
(:meth:`KoopmanModel.integrate_latent_ode`, dopri5 or RK4) integrates in
float32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.models.lista import LISTA
from kmpc_tpu_torch.models.mlp import MLP, matmul_f32

MODEL_NAMES = ("GenericKM", "SparseKM", "LISTAKM")
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero subgradient at v = 0. With sparse LISTA codes a
    residual row that is exactly zero is routine (a sample whose codes are
    all soft-thresholded on both sides), and the plain norm's v / ||v||
    there would make every gradient of the batch NaN."""
    sq = torch.sum(v * v, dim=dim)
    is_zero = sq == 0.0
    return torch.where(is_zero, torch.zeros_like(sq),
                       torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))


def _l1(z: torch.Tensor) -> torch.Tensor:
    """Mean over samples of the latent L1 norm."""
    return torch.mean(torch.sum(torch.abs(z), dim=-1))


class KoopmanModel(nn.Module):
    def __init__(
        self,
        observation_size: int,
        target_size: int,
        model_name: str = "GenericKM",
        norm_fn: str = "id",
        encoder_layers=(16, 16),
        encoder_activation: str = "relu",
        encoder_use_bias: bool = False,
        encoder_last_relu: bool = False,
        decoder_layers=(),
        decoder_activation: str = "relu",
        decoder_use_bias: bool = False,
        lista_num_loops: int = 10,
        lista_alpha: float = 0.1,
        lista_L: float = 1e3,
        lista_linear_encoder: bool = False,
        res_coeff: float = 1.0,
        reconst_coeff: float = 0.02,
        pred_coeff: float = 0.0,
        sparsity_coeff: float = 1e-3,
        rollout_impl: str = "scan",
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if model_name not in MODEL_NAMES:
            raise ValueError(f"Unknown model '{model_name}'. Available: "
                             f"{list(MODEL_NAMES)}")
        if norm_fn not in ("id", "ball"):
            raise ValueError(f"Unknown norm function '{norm_fn}'")
        if rollout_impl not in ("scan", "kpower"):
            raise ValueError(f"Unknown rollout '{rollout_impl}' (scan|kpower)")
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"Unknown compute_dtype '{compute_dtype}' "
                             f"({'|'.join(COMPUTE_DTYPES)})")
        self.compute_dtype = compute_dtype
        self._cd: Optional[torch.dtype] = COMPUTE_DTYPES[compute_dtype]
        self.model_name = model_name
        self.observation_size = observation_size
        self.target_size = target_size
        self.norm_fn = norm_fn
        self.lista_alpha = lista_alpha
        self.res_coeff, self.reconst_coeff = res_coeff, reconst_coeff
        self.pred_coeff, self.sparsity_coeff = pred_coeff, sparsity_coeff
        self.rollout_impl = rollout_impl
        if model_name == "LISTAKM":
            self.dict = nn.Parameter(torch.zeros(target_size, observation_size))
            self.lista = LISTA(observation_size, target_size, lista_num_loops,
                               lista_alpha, lista_L, lista_linear_encoder,
                               encoder_layers, encoder_use_bias,
                               encoder_activation, encoder_last_relu)
        else:
            self.encoder = MLP(observation_size, target_size, encoder_layers,
                               encoder_use_bias, encoder_activation,
                               encoder_last_relu)
            self.decoder = MLP(target_size, observation_size, decoder_layers,
                               decoder_use_bias, decoder_activation, False)
        self.kmat = nn.Parameter(torch.eye(target_size))

    @property
    def is_lista(self) -> bool:
        return self.model_name == "LISTAKM"

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "KoopmanModel":
        """Fresh weights from ``generator``: the MLPs uniform in
        +-1/sqrt(fan_in); LISTAKM's dictionary 0.01 randn and LISTA's
        initialisation from it; K the identity."""
        if self.is_lista:
            wd = 0.01 * torch.randn(self.observation_size, self.target_size,
                                    generator=generator,
                                    device=generator.device)
            self.dict.copy_(wd.T)
            self.lista.init_params(self.dict, generator)
        else:
            self.encoder.init_params(generator)
            self.decoder.init_params(generator)
        self.kmat.copy_(torch.eye(self.target_size))
        return self

    # ------------------------------------------------------------- core ops

    def _f32(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in float32 (a no-op in float32 compute)."""
        return t if self._cd is None else t.float()

    def _kmat_mul(self, z: torch.Tensor) -> torch.Tensor:
        """z @ K, in the compute dtype with float32 accumulation."""
        if self._cd is None:
            return z @ self.kmat
        return matmul_f32(z.to(self._cd), self.kmat.to(self._cd)).to(self._cd)

    def _apply_norm(self, z: torch.Tensor) -> torch.Tensor:
        """The latent normalization; the norm itself in float32, the output
        in z's dtype."""
        if self.norm_fn == "id":
            return z
        n = torch.linalg.vector_norm(self._f32(z), dim=-1, keepdim=True)
        return z / n.to(z.dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[..., obs] -> [..., z]."""
        if self.is_lista:
            return self.lista(x, self._cd)
        return self._apply_norm(self.encoder(x, self._cd))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[..., z] -> [..., obs]; LISTAKM through the dictionary's rows
        normalised, their norms clamped at 1e-4."""
        if self.is_lista:
            norms = torch.clamp(
                torch.linalg.vector_norm(self.dict, dim=1, keepdim=True),
                min=1e-4)
            if self._cd is None:
                return z @ (self.dict / norms)
            return matmul_f32(z.to(self._cd),
                              (self.dict / norms).to(self._cd)).to(self._cd)
        return self.decoder(z, self._cd)

    def step_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z @ K, then the latent normalization (none for LISTAKM)."""
        if self.is_lista:
            return self._kmat_mul(z)
        return self._apply_norm(self._kmat_mul(z))

    def step_env(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.step_latent(self.encode(x)))

    # ----------------------------------------------------- losses & metrics

    def residual(self, x: torch.Tensor, nx: torch.Tensor) -> torch.Tensor:
        """||enc(x) K - enc(nx)|| per sample (the raw K product)."""
        return _safe_norm(self._f32(self._kmat_mul(self.encode(x)))
                          - self._f32(self.encode(nx)))

    def reconstruction(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

    def sparsity_loss(self, x: torch.Tensor) -> torch.Tensor:
        """Mean L1 of the latents; LISTAKM's scaled by alpha."""
        l1 = _l1(self._f32(self.encode(x)))
        return self.lista_alpha * l1 if self.is_lista else l1

    def _total(self, residual, reconst, prediction, sparsity, zx):
        num_nonzero = torch.mean(torch.sum((zx != 0).float(), dim=-1))
        total = (self.res_coeff * residual + self.reconst_coeff * reconst
                 + self.pred_coeff * prediction
                 + self.sparsity_coeff * sparsity)
        return total, {
            "loss": total,
            "residual_loss": residual,
            "reconst_loss": reconst,
            "prediction_loss": prediction,
            "sparsity_loss": sparsity,
            "sparsity_ratio": 1.0 - num_nonzero / self.target_size,
        }

    def loss(self, x: torch.Tensor, nx: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Single-step loss and its metrics (x, nx: [B, obs]), reduced in
        float32."""
        f32 = self._f32
        zx, znx = self.encode(x), self.encode(nx)
        kzx = self._kmat_mul(zx)
        prediction = torch.mean(_safe_norm(f32(self.decode(kzx)) - nx))
        residual = torch.mean(_safe_norm(f32(kzx) - f32(znx)))
        reconst = (torch.mean(_safe_norm(x - f32(self.decode(zx))))
                   + torch.mean(_safe_norm(nx - f32(self.decode(znx)))))
        alpha = self.lista_alpha if self.is_lista else 1.0
        sparsity = 0.5 * alpha * (_l1(f32(zx)) + _l1(f32(znx)))
        return self._total(residual, reconst, prediction, sparsity, zx)

    def rollout_latent_discrete(self, z0: torch.Tensor, num_steps: int
                                ) -> torch.Tensor:
        """z_{t+k} = z_t K^k (the raw K product); [B, num_steps+1, z]
        including z0. ``rollout_impl="kpower"`` forms K^1..K^T first and
        applies them in one batched product."""
        if self.rollout_impl == "kpower":
            return self.rollout_latent_discrete_kpower(z0, num_steps)
        if self._cd is not None:
            z0 = z0.to(self._cd)
        traj = [z0]
        for _ in range(num_steps):
            traj.append(self._kmat_mul(traj[-1]))
        return torch.stack(traj, dim=1)

    def rollout_latent_discrete_kpower(self, z0: torch.Tensor,
                                       num_steps: int) -> torch.Tensor:
        if num_steps < 1:
            return z0[:, None, :]
        cd = self._cd
        if cd is None:
            powers = [self.kmat]
            for _ in range(num_steps - 1):
                powers.append(powers[-1] @ self.kmat)
            traj = torch.einsum("bz,tzk->btk", z0, torch.stack(powers))
            return torch.cat([z0[:, None, :], traj], dim=1)
        z0, kmat = z0.to(cd), self.kmat.to(cd)
        powers = [kmat]
        for _ in range(num_steps - 1):
            powers.append(matmul_f32(powers[-1], kmat).to(cd))
        kp = torch.stack(powers)                         # [T, z, k]
        T, z, k = kp.shape
        traj = matmul_f32(z0, kp.permute(1, 0, 2).reshape(z, T * k))
        traj = traj.reshape(-1, T, k).to(cd)
        return torch.cat([z0[:, None, :], traj], dim=1)

    def rollout_sequence(self, x0: torch.Tensor, num_steps: int
                         ) -> torch.Tensor:
        """Observation-space rollout [B, num_steps+1, obs]."""
        z0 = self.encode(x0)
        return self.decode(self.rollout_latent_discrete(z0, num_steps))

    def loss_sequence(self, x_seq: torch.Tensor, dt: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sequence loss with the discrete Koopman rollout; x_seq
        [B, T+1, obs] holds x_t..x_{t+T}. Alignment (named
        ``residual_loss``) sum_t ||zhat_t - z_t||^2 for t = 1..T,
        reconstruction sum_t ||x_t - dec(z_t)||^2 for t = 0..T, prediction
        sum_t ||x_t - dec(zhat_t)||^2 for t = 1..T, sparsity mean ||z||_1;
        reduced in float32."""
        f32 = self._f32
        z_seq = self.encode(x_seq)
        z_hat = self.rollout_latent_discrete(z_seq[:, 0, :],
                                             x_seq.shape[1] - 1)
        x_tilde = f32(self.decode(z_seq))
        x_hat = f32(self.decode(z_hat))
        z_seq, z_hat = f32(z_seq), f32(z_hat)

        def sq_sum(d):
            return torch.mean(torch.sum(torch.sum(d ** 2, dim=-1), dim=1))

        alignment = sq_sum(z_hat[:, 1:, :] - z_seq[:, 1:, :])
        reconst = sq_sum(x_seq - x_tilde)
        prediction = sq_sum(x_seq[:, 1:, :] - x_hat[:, 1:, :])
        return self._total(alignment, reconst, prediction, _l1(z_seq), z_seq)

    # -------------------------------------------------- continuous-time ODE

    def koopman_ode_func(self, z: torch.Tensor) -> torch.Tensor:
        """dz/dt = z @ K."""
        return z @ self.kmat

    def integrate_latent_ode(self, z0: torch.Tensor, t_span: torch.Tensor,
                             method: str = "dopri5") -> torch.Tensor:
        """The latent ODE dz/dt = z K from z0 [B, z] over ``t_span`` [T]:
        [T, B, z], z0 first. ``dopri5``: Dormand-Prince 5(4) with adaptive
        steps (rtol 1e-5, atol 1e-7), each step ending on the next point of
        ``t_span`` where it would pass it; ``rk4``: one classical RK4 step
        between neighbouring points of a possibly non-uniform ``t_span``.
        Always in float32, whatever the compute dtype."""
        z0 = z0.float()
        t_span = t_span.to(device=z0.device, dtype=torch.float32)
        f = self.koopman_ode_func
        if method == "dopri5":
            return dopri5(f, z0, t_span, rtol=1e-5, atol=1e-7)
        if method != "rk4":
            raise ValueError(f"Unknown ODE method '{method}' (dopri5|rk4)")
        traj = [z0]
        for dt in (t_span[1:] - t_span[:-1]).unbind(0):
            z = traj[-1]
            k1 = f(z)
            k2 = f(z + 0.5 * dt * k1)
            k3 = f(z + 0.5 * dt * k2)
            k4 = f(z + dt * k3)
            traj.append(z + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4))
        return torch.stack(traj)

    def rollout_sequence_ode(self, x0: torch.Tensor, num_steps: int,
                             dt: float, method: str = "dopri5"
                             ) -> torch.Tensor:
        """The ODE rollout decoded to observations, [num_steps+1, B, obs];
        the decode in the compute dtype."""
        z0 = self.encode(x0)
        t_span = torch.arange(num_steps + 1, dtype=torch.float32,
                              device=z0.device) * dt
        return self.decode(self.integrate_latent_ode(z0, t_span, method))


# Dormand-Prince 5(4): the nodes, the stages' weights, the fifth-order
# solution's weights (the seventh stage is f at the new point) and the
# error's weights (fifth minus fourth order).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = ((),
         (1 / 5,),
         (3 / 40, 9 / 40),
         (44 / 45, -56 / 15, 32 / 9),
         (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
         (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
         (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
_DP_E = (35 / 384 - 5179 / 57600, 0.0, 500 / 1113 - 7571 / 16695,
         125 / 192 - 393 / 640, -2187 / 6784 + 92097 / 339200,
         11 / 84 - 187 / 2100, -1 / 40)


def _rms(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(x * x)))


def dopri5(f, y0: torch.Tensor, t_span: torch.Tensor, rtol: float = 1e-5,
           atol: float = 1e-7, max_steps: int = 100_000) -> torch.Tensor:
    """y' = f(y) (autonomous) from y0 over ``t_span`` [T] (increasing):
    [T, *y0.shape]. Dormand-Prince 5(4) with the error measured as the RMS
    over every element of err / (atol + rtol max(|y|, |y_new|)), the
    first step by Hairer's rule and each next one by
    0.9 ratio^(-1/5) within [0.2, 10] (jax.experimental.ode's
    controller); a step that would pass the next output time ends on it.
    Steps are taken on the host's decision, one synchronisation each."""
    ts = [float(t) for t in t_span.tolist()]
    y, k1 = y0, f(y0)
    out = [y0]
    # The first step (Hairer, Norsett and Wanner, II.4).
    scale = atol + rtol * y0.abs()
    d0, d1 = _rms(y0 / scale), _rms(k1 / scale)
    h0 = 1e-6 if d0 < 1e-5 or d1 < 1e-5 else 0.01 * d0 / d1
    d2 = _rms((f(y0 + h0 * k1) - k1) / scale) / h0
    h1 = (max(1e-6, h0 * 1e-3) if max(d1, d2) <= 1e-15
          else (0.01 / max(d1, d2)) ** (1.0 / 5.0))
    h = min(100.0 * h0, h1)
    t, steps = ts[0], 0
    for target in ts[1:]:
        while t < target:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"dopri5: more than {max_steps} steps")
            step = min(h, target - t)
            last = step >= target - t
            ks = [k1]
            for a in _DP_A[1:6]:
                ks.append(f(y + step * sum(c * k for c, k in zip(a, ks))))
            y_new = y + step * sum(c * k for c, k in zip(_DP_A[6], ks)
                                   if c != 0.0)
            k7 = f(y_new)
            err = step * sum(c * k for c, k in zip(_DP_E, ks + [k7])
                             if c != 0.0)
            ratio = _rms(err / (atol + rtol * torch.maximum(y.abs(),
                                                            y_new.abs())))
            factor = (10.0 if ratio == 0.0
                      else min(10.0, max(0.2, 0.9 * ratio ** -0.2)))
            if ratio <= 1.0:
                t = target if last else t + step
                y, k1 = y_new, k7
                # A step cut short to land on an output time keeps h.
                h = max(h, step * factor) if last else step * factor
            else:
                h = step * min(factor, 1.0)
            if not math.isfinite(h) or h <= 0.0:
                raise RuntimeError("dopri5: the step size vanished")
        out.append(y)
    return torch.stack(out)


def spectral_metrics(kmat: torch.Tensor) -> Dict[str, float]:
    """Largest real part and largest modulus of K's spectrum, computed on
    the host in numpy; NaN for a K that is not finite."""
    k = kmat.detach().cpu().numpy()
    if not np.all(np.isfinite(k)):
        return {"A_max_eigenvalue_real": float("nan"),
                "A_max_eigenvalue": float("nan")}
    eig = np.linalg.eigvals(k)
    return {"A_max_eigenvalue_real": float(np.max(eig.real)),
            "A_max_eigenvalue": float(np.max(np.abs(eig)))}


def make_model(cfg: Config, observation_size: int,
               device: Union[str, torch.device] = "cuda") -> KoopmanModel:
    """Build the KoopmanModel that ``cfg.MODEL`` describes, computing in
    ``cfg.TRAIN.DTYPE``, on ``device``."""
    m = cfg.MODEL
    lista = m.ENCODER.LISTA
    return KoopmanModel(
        observation_size=observation_size,
        target_size=m.TARGET_SIZE,
        model_name=m.MODEL_NAME,
        norm_fn=m.NORM_FN,
        encoder_layers=tuple(m.ENCODER.LAYERS),
        encoder_activation=m.ENCODER.ACTIVATION,
        encoder_use_bias=m.ENCODER.USE_BIAS,
        encoder_last_relu=m.ENCODER.LAST_RELU,
        decoder_layers=tuple(m.DECODER.LAYERS),
        decoder_activation=m.DECODER.ACTIVATION,
        decoder_use_bias=m.DECODER.USE_BIAS,
        lista_num_loops=lista.NUM_LOOPS,
        lista_alpha=lista.ALPHA,
        lista_L=lista.L,
        lista_linear_encoder=lista.LINEAR_ENCODER,
        res_coeff=m.RES_COEFF,
        reconst_coeff=m.RECONST_COEFF,
        pred_coeff=m.PRED_COEFF,
        sparsity_coeff=m.SPARSITY_COEFF,
        rollout_impl=cfg.TRAIN.ROLLOUT,
        compute_dtype=cfg.TRAIN.DTYPE,
    ).to(device)
