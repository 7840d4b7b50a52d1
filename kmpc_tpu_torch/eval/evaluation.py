"""The systems' evaluation protocol: rollout modes, horizon MSE, the
Lyapunov basins and the plots (port of kmpc_tpu/eval/evaluation.py).

Each rollout mode is one batched ``ops/rollout.py`` ``rollout`` over every
initial state; the metrics are NaN-masked horizon MSEs over the initial
states with the best re-encoding period per horizon. On the Lyapunov
system the basin assignment of a 15 x 15 grid of initial states rolled
2000 steps under the true and the learned dynamics is computed too. The
figures are best-effort: matplotlib is imported where they are drawn, and
without it no figure is written; the metrics and ``metrics.json`` never
depend on it.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kmpc_tpu_torch import stream_seed
from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.data.systems import (
    _LYAPUNOV_POINTS, DynamicalSystem, make_system,
)
from kmpc_tpu_torch.models.koopman import KoopmanModel
from kmpc_tpu_torch.ops.rollout import rollout

Device = Union[str, torch.device]


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host in float32 (bfloat16 has no numpy type)."""
    return t.detach().float().cpu().numpy()


# ---------------------------------------------------------------------------
# Metric helpers
# ---------------------------------------------------------------------------


def compute_horizon_mse(
    squared_errors: np.ndarray, horizon: int
) -> Tuple[float, float, List[float], int]:
    """Mean and std over initial states of the MSE up to ``horizon``,
    NaN-masked, the per-state values and how many are finite.

    squared_errors: [time, batch] per-step squared L2 norms.
    """
    horizon = min(horizon, squared_errors.shape[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        per_ic = np.nanmean(squared_errors[:horizon], axis=0)
    valid = np.isfinite(per_ic)
    if valid.sum() == 0:
        return float("nan"), float("nan"), [], 0
    vals = per_ic[valid]
    mean = float(vals.mean())
    std = float(vals.std()) if vals.size > 1 else 0.0
    return mean, std, vals.tolist(), int(valid.sum())


def cumulative_mse_curve(squared_errors: np.ndarray) -> List[float]:
    """The cumulative MSE up to each step, averaged over initial states."""
    steps = np.arange(1, squared_errors.shape[0] + 1, dtype=np.float64)
    cumulative = np.cumsum(squared_errors, axis=0)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        curve = np.nanmean(cumulative / steps[:, None], axis=1)
    return curve.tolist()


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


@dataclass
class EvaluationSettings:
    systems: Sequence[str] = ("duffing", "lyapunov")
    horizons: Sequence[int] = (100, 1000)
    periodic_reencode_periods: Sequence[int] = (10, 25, 50, 100)
    batch_size: int = 100
    phase_portrait_samples: int = 20
    phase_portrait_length: int = 200
    phase_portrait_reencode_periods: Sequence[int] = (0, 1, 10, 25, 50)
    phase_portrait_batch_size: int = 256
    seed_offset: int = 12345


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


def initial_states(system: DynamicalSystem, cfg: Config,
                   settings: EvaluationSettings,
                   device: Device) -> torch.Tensor:
    """The evaluation's initial states [batch, D]: drawn on ``device`` by a
    generator seeded from ``SEED + seed_offset``."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(cfg.SEED + settings.seed_offset))
    return system.reset(gen, settings.batch_size)


def evaluate_model(
    model: KoopmanModel,
    cfg: Config,
    settings: Optional[EvaluationSettings] = None,
    output_dir: Optional[Path] = None,
    verbose: bool = True,
) -> Dict[str, Dict]:
    """Evaluate a trained model on each of ``settings.systems`` whose
    observation size is the model's, on the model's device; with
    ``output_dir`` the figures under ``<output_dir>/<system>/`` and
    ``metrics.json``."""
    if settings is None:
        settings = EvaluationSettings()
    device = model.kmat.device
    results: Dict[str, Dict] = {}
    for system_name in settings.systems:
        system = make_system(cfg, system_name)
        if system.observation_size != model.observation_size:
            if verbose:
                print(f"[evaluate_model] skip '{system_name}': obs "
                      f"{system.observation_size} != model "
                      f"{model.observation_size}")
            continue
        x0 = initial_states(system, cfg, settings, device)
        results[system_name] = _evaluate_system(
            model, system, settings, x0, output_dir, verbose)
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        metrics_path = output_dir / "metrics.json"
        with open(metrics_path, "w") as f:
            json.dump(results, f, indent=2)
        results["metrics_file"] = str(metrics_path)
    return results


@torch.no_grad()
def _evaluate_system(model: KoopmanModel, system: DynamicalSystem,
                     settings: EvaluationSettings, init_states: torch.Tensor,
                     output_dir: Optional[Path], verbose: bool) -> Dict:
    """One system's metrics from the initial states ``init_states``
    [batch, D] (the seam the tests feed kmpc_tpu's states through), and the
    Lyapunov system's basins."""
    name = system.name
    max_horizon = max(settings.horizons)
    if verbose:
        print(f"[evaluate_model] system '{name}' "
              f"(batch={init_states.shape[0]}, horizon={max_horizon})")
    true_future = _np(system.trajectory(init_states, max_horizon))
    periods = {"no_reencode": 0, "every_step": 1}
    for period in settings.periodic_reencode_periods:
        periods[f"periodic_{period}"] = period
    predictions = {mode: _np(rollout(model, init_states, max_horizon, p))
                   for mode, p in periods.items()}

    # Parabolic decays to the origin too fast for a horizon past 100.
    horizons = [h for h in settings.horizons
                if not (name == "parabolic" and h > 100)]
    mode_metrics: Dict[str, Dict] = {}
    periodic_summary: Dict[str, Dict] = {str(h): {} for h in horizons}
    per_step_errors: Dict[str, np.ndarray] = {}
    for mode, pred in predictions.items():
        diff = pred - true_future
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            per_step_errors[mode] = np.nanmean(
                np.linalg.norm(diff, axis=-1), axis=1)
        squared = np.sum(diff ** 2, axis=-1)
        squared = np.where(np.isfinite(squared), squared, np.nan)
        horizons_metrics = {}
        for horizon in horizons:
            mean, std, per_ic, num_valid = compute_horizon_mse(squared,
                                                               horizon)
            horizons_metrics[str(horizon)] = {
                "mean": mean, "std": std,
                "num_valid": num_valid, "values": per_ic,
            }
            if mode.startswith("periodic_") and num_valid > 0:
                periodic_summary[str(horizon)][mode] = mean
        mode_metrics[mode] = {"horizons": horizons_metrics,
                              "mse_curve": cumulative_mse_curve(squared)}

    best_periodic: Dict[str, Dict] = {}
    for hk, candidates in periodic_summary.items():
        if candidates:
            mode, mean = min(candidates.items(), key=lambda kv: kv[1])
            best_periodic[hk] = {"mode": mode, "mean": mean}

    out: Dict = {"modes": mode_metrics, "best_periodic": best_periodic}
    basins = lyapunov_basins(model, system) if name == "lyapunov" else None
    if basins is not None:
        out["basins"] = {k: v.tolist() if isinstance(v, np.ndarray) else v
                         for k, v in basins.items()
                         if k not in ("true_traj", "pred_traj")}
    files: Dict[str, str] = {}
    if output_dir is not None:
        system_dir = Path(output_dir) / name
        system_dir.mkdir(parents=True, exist_ok=True)
        files = _plots(model, system, settings, true_future, predictions,
                       per_step_errors, mode_metrics, basins, system_dir)
    out["files"] = files
    return out


def _estimate_attractors(trajectories: np.ndarray,
                         decimals: int = 1) -> np.ndarray:
    """The distinct finite end points of ``trajectories`` [T, B, D],
    rounded to ``decimals``: the attractors they reach. A rounded -0.0
    becomes 0.0: ``np.unique`` tells the two apart by their bits, which
    would count one attractor twice."""
    finals = trajectories[-1]
    finals = finals[np.all(np.isfinite(finals), axis=-1)]
    if len(finals) == 0:
        return np.zeros((0, trajectories.shape[-1]))
    return np.unique(np.round(finals, decimals) + 0.0, axis=0)


def basin_assignment(finals: np.ndarray, attractors: np.ndarray
                     ) -> np.ndarray:
    """For each end point [B, D], the index of the nearest attractor
    (clipped to +-10 first); -1 where the end point is not finite or there
    is no attractor."""
    from scipy.spatial import cKDTree

    assign = np.full(finals.shape[0], -1, dtype=np.int64)
    ok = np.all(np.isfinite(finals), axis=-1)
    if len(attractors) and ok.any():
        _, idx = cKDTree(attractors).query(np.clip(finals[ok], -10, 10))
        assign[ok] = idx
    return assign


@torch.no_grad()
def lyapunov_basins(model: KoopmanModel, system: DynamicalSystem,
                    grid_n: int = 15, lim: float = 2.5,
                    steps: int = 2000) -> Dict:
    """The basin comparison on the Lyapunov system: a ``grid_n`` x
    ``grid_n`` grid of initial states in [-lim, lim]^2 rolled ``steps``
    steps under the true dynamics and under the model (re-encoding every
    step); the true attractors are the distinct rounded end points of the
    true rollouts, and each initial state is assigned the attractor nearest
    its end point under either dynamics (-1 where it is not finite)."""
    grid = np.linspace(-lim, lim, grid_n)
    xx, yy = np.meshgrid(grid, grid)
    x0 = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], axis=-1),
                         dtype=torch.float32, device=model.kmat.device)
    true_traj = _np(system.trajectory(x0, steps))
    pred_traj = _np(rollout(model, x0, steps, 1))
    attractors = _estimate_attractors(true_traj)
    true_assign = basin_assignment(true_traj[-1], attractors)
    pred_assign = basin_assignment(pred_traj[-1], attractors)
    return {
        "grid_n": grid_n, "steps": steps,
        "initial_states": _np(x0),
        "true_attractors": attractors,
        "true_assignment": true_assign,
        "learned_assignment": pred_assign,
        "agreement": float(np.mean(true_assign == pred_assign)),
        "true_traj": true_traj, "pred_traj": pred_traj,
    }


# ---------------------------------------------------------------------------
# Figures (best-effort)
# ---------------------------------------------------------------------------


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plots(model, system, settings, true_future, predictions,
           per_step_errors, mode_metrics, basins, system_dir) -> Dict[str, str]:
    """The system's figures, {name: path}; none without matplotlib."""
    try:
        _mpl()
    except ImportError as e:
        warnings.warn(f"matplotlib is not available ({e}); no evaluation "
                      f"figures for {system.name}", stacklevel=2)
        return {}
    try:
        return _save_system_plots(model, system, settings, true_future,
                                  predictions, per_step_errors, mode_metrics,
                                  basins, system_dir)
    except Exception as e:  # plots are best-effort
        print(f"[warn] plotting failed for {system.name}: {e}")
        return {}


def _save_system_plots(model, system, settings, true_future, predictions,
                       per_step_errors, mode_metrics, basins, system_dir
                       ) -> Dict[str, str]:
    files: Dict[str, str] = {}
    path = system_dir / "phase_portrait_plot_eval.png"
    _save_phase_portrait_grid(model, system, settings, path)
    files["phase_portrait_plot_eval"] = str(path)

    path = system_dir / "phase_portrait_overlay.png"
    _save_phase_portrait_overlay(true_future, predictions, path,
                                 max_samples=settings.phase_portrait_samples)
    files["phase_portrait_overlay"] = str(path)

    for mode, pred in predictions.items():
        p = system_dir / f"phase_portrait_{mode}.png"
        _save_phase_portrait_single_mode(
            true_future, pred, p, max_samples=settings.phase_portrait_samples,
            title=f"Phase portrait ({mode})")
        if p.exists():
            files[f"phase_portrait_{mode}"] = str(p)

    path = system_dir / "mse_vs_horizon.png"
    _save_mse_curves({m: d["mse_curve"] for m, d in mode_metrics.items()},
                     settings.horizons, path)
    files["mse_curve"] = str(path)

    for mode, errors in per_step_errors.items():
        p = system_dir / f"error_curve_{mode}.png"
        _save_error_curve({mode: errors}, p, f"Per-step error ({mode})")
        files[f"error_curve_{mode}"] = str(p)

    path = system_dir / "error_curve_combined.png"
    _save_error_curve(per_step_errors, path, "Per-step error (all modes)",
                      highlight=settings.horizons)
    files["error_curve_combined"] = str(path)

    if basins is not None:
        files.update(_save_lyapunov_comparison(model, system, basins,
                                               system_dir))
    return files


def _save_phase_portrait_overlay(true_future, predictions, path: Path,
                                 max_samples: int = 20) -> None:
    """Every rollout mode on one axes, the truth in transparent grey; a
    trajectory with a non-finite prediction in any mode is dropped."""
    if true_future.shape[-1] < 2:
        return
    plt = _mpl()
    batch = true_future.shape[1]
    finite = np.ones(batch, dtype=bool)
    for pred in predictions.values():
        finite &= np.isfinite(pred.reshape(pred.shape[0], batch, -1)).all(
            axis=(0, 2))
    idx = np.nonzero(finite)[0][:max_samples]
    if len(idx) == 0:
        return
    fig, ax = plt.subplots(figsize=(7, 6))
    for b in idx:
        ax.plot(true_future[:, b, 0], true_future[:, b, 1],
                color=(0.5, 0.5, 0.5), alpha=0.25, lw=1.5)
    cmap = plt.get_cmap("tab10")
    for k, (mode, pred) in enumerate(sorted(predictions.items())):
        for j, b in enumerate(idx):
            ax.plot(pred[:, b, 0], pred[:, b, 1], color=cmap(k % 10),
                    alpha=0.6, lw=0.9, label=mode if j == 0 else None)
    ax.set_xlabel("x1")
    ax.set_ylabel("x2")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _save_phase_portrait_single_mode(true_future, predicted, path: Path,
                                     max_samples: int = 20,
                                     title: Optional[str] = None,
                                     axis_lim: float = 2.5) -> None:
    """One rollout mode, each trajectory in its own tab20 colour, the truth
    in light grey on top."""
    if true_future.shape[-1] < 2:
        return
    plt = _mpl()
    batch = predicted.shape[1]
    finite = np.isfinite(predicted.reshape(predicted.shape[0], batch, -1)
                         ).all(axis=(0, 2))
    idx = np.nonzero(finite)[0][:max_samples]
    if len(idx) == 0:
        return
    fig, ax = plt.subplots(1, 1, figsize=(7, 6))
    cmap = plt.get_cmap("tab20", len(idx))
    for j, b in enumerate(idx):
        ax.plot(predicted[:, b, 0], predicted[:, b, 1], color=cmap(j),
                linewidth=1.5, zorder=2)
        ax.plot(true_future[:, b, 0], true_future[:, b, 1],
                color=(0.6, 0.6, 0.6), alpha=0.5, linewidth=1.5, zorder=3)
    ax.set_xlabel("x1")
    ax.set_ylabel("x2")
    ax.set_title(title or "Phase portrait (single mode)")
    ax.set_xlim(-axis_lim, axis_lim)
    ax.set_ylim(-axis_lim, axis_lim)
    ax.set_aspect("equal", adjustable="box")
    ax.grid(True, linestyle=":", alpha=0.4)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _save_phase_portrait_grid(model, system, settings, path: Path) -> None:
    """The truth beside each re-encoding period of the portrait settings,
    from initial states drawn by a generator seeded from seed_offset + 1."""
    if system.observation_size < 2:
        return
    plt = _mpl()
    n = settings.phase_portrait_samples
    length = settings.phase_portrait_length
    device = model.kmat.device
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(settings.seed_offset + 1))
    x0 = system.reset(gen, n)
    true = _np(system.trajectory(x0, length))
    x0n = _np(x0)
    periods = list(settings.phase_portrait_reencode_periods)
    fig, axes = plt.subplots(1, len(periods) + 1,
                             figsize=(4 * (len(periods) + 1), 4))
    axes[0].set_title("ground truth")
    for b in range(n):
        axes[0].plot(np.concatenate([[x0n[b, 0]], true[:, b, 0]]),
                     np.concatenate([[x0n[b, 1]], true[:, b, 1]]),
                     color="gray", alpha=0.4, lw=1.0)
    for ax, period in zip(axes[1:], periods):
        pred = _np(rollout(model, x0, length, period))
        ax.set_title({0: "no reencode", 1: "every step"}.get(
            period, f"periodic {period}"))
        for b in range(n):
            ax.plot(true[:, b, 0], true[:, b, 1], color="gray", alpha=0.2,
                    lw=1.0)
            ax.plot(pred[:, b, 0], pred[:, b, 1], lw=1.0)
    for ax in axes:
        ax.set_xlabel("x1")
        ax.set_ylabel("x2")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _save_mse_curves(curves: Dict[str, List[float]], horizons, path: Path):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    for mode, curve in curves.items():
        ax.plot(np.arange(1, len(curve) + 1), curve, label=mode, lw=1.2)
    for h in horizons:
        ax.axvline(h, color="k", ls=":", alpha=0.3)
    ax.set_xlabel("horizon")
    ax.set_ylabel("cumulative MSE")
    ax.set_yscale("log")
    ax.set_xscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _save_error_curve(errors: Dict[str, np.ndarray], path: Path, title: str,
                      highlight=()):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    for mode, err in errors.items():
        ax.plot(err, label=mode, lw=1.2)
    for h in highlight:
        if h <= max(len(e) for e in errors.values()):
            ax.axvline(h, color="k", ls=":", alpha=0.3)
    ax.set_xlabel("step")
    ax.set_ylabel("mean L2 error")
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def _save_vector_magnitude_histogram(magnitudes, path: Path, title: str):
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    mags = np.asarray(magnitudes).ravel()
    mags = mags[np.isfinite(mags)]
    if len(mags):
        ax.hist(mags, bins=50, alpha=0.8, density=True)
    ax.set_xlabel("|dx/dt|")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


@torch.no_grad()
def _save_lyapunov_comparison(model, system, basins, system_dir: Path,
                              num_trajectories: int = 12,
                              grid_lim: float = 3.0,
                              grid_n: int = 15) -> Dict[str, str]:
    """The true and the learned attractors on Voronoi regions with the
    vector fields and trajectory fans coloured by nearest attractor, each
    panel's magnitude histogram, the basin-assignment grid and a histogram
    of the basin rollouts' magnitudes."""
    plt = _mpl()
    from matplotlib import cm
    from scipy.spatial import Voronoi

    files: Dict[str, str] = {}
    device = model.kmat.device
    dt = float(system.dt)
    steps = max(int(8.0 / dt), 75)
    true_points = np.asarray(_LYAPUNOV_POINTS)
    gen = torch.Generator(device=device).manual_seed(stream_seed(777))
    est_x0 = (torch.rand(max(grid_n ** 2, 64), 2, generator=gen,
                         device=device) * 2.0 - 1.0) * grid_lim
    learned_points = _estimate_attractors(_np(rollout(model, est_x0, steps, 1)))
    if len(learned_points):
        kept: List[np.ndarray] = []
        for p in learned_points:
            if not kept or np.min(np.linalg.norm(np.asarray(kept) - p,
                                                 axis=-1)) > 0.2:
                kept.append(p)
        learned_points = np.asarray(kept)

    xs = np.linspace(-grid_lim, grid_lim, grid_n)
    X, Y = np.meshgrid(xs, xs)
    grid_states = torch.as_tensor(np.stack([X.ravel(), Y.ravel()], axis=-1),
                                  dtype=torch.float32, device=device)
    vel_true = (_np(system.step(grid_states)) - _np(grid_states)) / dt
    vel_learned = (_np(model.step_env(grid_states)) - _np(grid_states)) / dt

    rng = np.random.default_rng(42)
    x0 = torch.as_tensor(rng.uniform(-2.5, 2.5, size=(num_trajectories, 2)),
                         dtype=torch.float32, device=device)
    traj_true = np.concatenate([_np(x0)[None],
                                _np(system.trajectory(x0, steps))], 0)
    traj_learned = np.concatenate([_np(x0)[None],
                                   _np(rollout(model, x0, steps, 1))], 0)

    fig, axes = plt.subplots(1, 2, figsize=(20, 8))
    panels = [
        (axes[0], "True System", true_points, vel_true, traj_true, "o", 0.25),
        (axes[1], "Learned System", learned_points, vel_learned,
         traj_learned, "s", 0.2),
    ]
    for ax, title, points, vel, trajs, marker, fill_alpha in panels:
        display = points if len(points) else true_points
        colors = cm.tab20(np.linspace(0, 1, max(len(display), 1)))
        if len(display) >= 3:
            vor = Voronoi(display)
            for i, region_idx in enumerate(vor.point_region):
                region = vor.regions[region_idx]
                if not region or -1 in region:
                    continue
                verts = np.asarray([vor.vertices[j] for j in region])
                if len(verts):
                    ax.fill(verts[:, 0], verts[:, 1],
                            color=colors[i % len(colors)], alpha=fill_alpha,
                            zorder=1)
            for simplex in vor.ridge_vertices:
                simplex = np.asarray(simplex)
                if np.all(simplex >= 0):
                    ax.plot(vor.vertices[simplex, 0], vor.vertices[simplex, 1],
                            "k-", linewidth=1.0, alpha=0.75, zorder=2)
        U = vel[:, 0].reshape(grid_n, grid_n)
        V = vel[:, 1].reshape(grid_n, grid_n)
        mags = np.sqrt(U ** 2 + V ** 2)
        den = np.where(mags == 0, 1.0, mags)
        max_mag = float(np.nanmax(mags)) if mags.size else 0.0
        lws = (0.75 + 2.25 * (mags / (max_mag + 1e-6))
               if max_mag > 0 else np.full_like(mags, 0.75))
        ax.quiver(X, Y, U / den, V / den, color="gray", alpha=0.65, scale=25,
                  linewidths=lws.ravel(), zorder=3)
        suffix = "learned" if title.startswith("Learned") else "true"
        hist_path = system_dir / f"phase_portrait_vector_hist_{suffix}.png"
        _save_vector_magnitude_histogram(mags, hist_path,
                                         f"{title} vector magnitudes")
        files[f"phase_portrait_vector_hist_{suffix}"] = str(hist_path)
        for k, p in enumerate(display):
            ax.plot(p[0], p[1], marker, color=colors[k % len(colors)],
                    markersize=10, markeredgecolor="black",
                    markeredgewidth=2, zorder=6)
        for b in range(trajs.shape[1]):
            t = trajs[:, b]
            t = t[np.all(np.isfinite(t), axis=-1)]
            if len(t) == 0:
                continue
            color = colors[int(np.argmin(np.linalg.norm(display - t[-1],
                                                        axis=-1)))
                           % len(colors)]
            ax.plot(t[:, 0], t[:, 1], color=color, lw=2.0, alpha=0.9,
                    zorder=4)
            ax.plot(t[0, 0], t[0, 1], marker, color=color, markersize=6,
                    alpha=0.9, markeredgecolor="white", markeredgewidth=1,
                    zorder=5)
        ax.set_xlim(-grid_lim, grid_lim)
        ax.set_ylim(-grid_lim, grid_lim)
        ax.set_xlabel("x1", fontsize=12)
        ax.set_ylabel("x2", fontsize=12)
        ax.set_title(title if suffix == "true" else f"{title} (Voronoi est.)",
                     fontsize=14)
        ax.grid(True, alpha=0.3)
        ax.set_aspect("equal")
    fig.tight_layout()
    comp_path = system_dir / "phase_portrait_comparison.png"
    fig.savefig(comp_path, dpi=150)
    plt.close(fig)
    files["phase_portrait_comparison"] = str(comp_path)

    # The basin-assignment grid: each initial state coloured by the
    # attractor its end point lands nearest under either dynamics.
    bx0 = basins["initial_states"]
    attractors = basins["true_attractors"]
    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, assign, title in [
            (axes[0], basins["true_assignment"], "true dynamics"),
            (axes[1], basins["learned_assignment"], "learned dynamics")]:
        ok = assign >= 0
        ax.scatter(bx0[ok, 0], bx0[ok, 1], c=assign[ok], s=18, cmap="tab20",
                   marker="s")
        if len(attractors):
            ax.scatter(attractors[:, 0], attractors[:, 1], c="k", s=30,
                       marker="x")
        ax.set_title(f"basins: {title}")
    fig.tight_layout()
    basin_path = system_dir / "basin_assignment.png"
    fig.savefig(basin_path, dpi=150)
    plt.close(fig)
    files["basin_assignment"] = str(basin_path)

    fig, ax = plt.subplots(figsize=(6, 4))
    tm = np.linalg.norm(basins["true_traj"].reshape(-1, 2), axis=-1)
    pm = np.linalg.norm(basins["pred_traj"].reshape(-1, 2), axis=-1)
    pm = pm[np.isfinite(pm)]
    ax.hist(tm, bins=50, alpha=0.5, label="true", density=True)
    if len(pm):
        ax.hist(pm, bins=50, alpha=0.5, label="learned", density=True)
    ax.set_xlabel("|x|")
    ax.legend()
    fig.tight_layout()
    hist_path = system_dir / "magnitude_histogram.png"
    fig.savefig(hist_path, dpi=150)
    plt.close(fig)
    files["magnitude_histogram"] = str(hist_path)
    return files
