"""FACTS-like sea-level projection science, in PyTorch (paper §4).

Counterpart of ``repro/facts/model.py``: a miniature of FACTS' 4-stage
workflow (Framework for Assessing Changes To Sea-level):

  pre-processing : synthesize + normalize a forcing series (GSAT anomaly)
                   and a short observed sea-level record per site (numpy,
                   bit for bit the reference's)
  fitting        : fit a semi-empirical emulator  dS/dt = a*T + b  (ridge
                   regression with parameter covariance), fp32 on ``device``
  projecting     : Monte-Carlo ensemble over emulator parameter uncertainty
                   + residual noise, integrated to 2100, fp32 on ``device``
  post-processing: quantiles (5/17/50/83/95) of projected rise (numpy)

``project`` is split in two.  :func:`draws` makes the three normal draws from
a ``torch.Generator`` seeded ``(seed << 16) ^ site`` on the target device;
:func:`project_from_draws` is a pure function of the fitted emulator and those
draws.  The reference draws with ``jax.random``, whose streams torch cannot
reproduce, so the two packages' ensembles differ sample by sample; fed the
same draws, ``project_from_draws`` matches the reference's projection.

The fit and projection run on ``device``, ``"cuda"`` by default; a CPU run
asks for ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

YEARS_HIST = 120  # observed record length
YEAR_END = 2100
N_SAMPLES = 1000
QUANTILES = (0.05, 0.17, 0.50, 0.83, 0.95)


def preprocess(site: int, seed: int = 0) -> dict:
    """Synthesize forcing + observations for a site; normalize."""
    rng = np.random.default_rng((seed, site))
    years = np.arange(1900, 1900 + YEARS_HIST)
    # GSAT anomaly: slow trend + ENSO-ish oscillation + noise
    trend = 0.008 * (years - 1900) + 0.004 * np.maximum(years - 1970, 0)
    osc = 0.08 * np.sin(2 * np.pi * (years - 1900) / 6.3)
    gsat = trend + osc + rng.normal(0, 0.05, YEARS_HIST)
    # "true" local sensitivity varies by site
    a_true = 1.8 + 0.6 * rng.normal()
    b_true = 0.3 + 0.1 * rng.normal()
    rate = a_true * gsat + b_true + rng.normal(0, 0.25, YEARS_HIST)  # mm/yr
    sea_level = np.cumsum(rate)  # mm
    gsat_n = (gsat - gsat.mean()) / (gsat.std() + 1e-9)
    return {
        "site": site,
        "years": years,
        "gsat": gsat,
        "gsat_norm": gsat_n,
        "sea_level_mm": sea_level,
    }


def fit(pre: dict, ridge: float = 1e-3, device="cuda") -> dict:
    """Fit dS/dt = a*T + b with ridge regression; return params + covariance."""
    gsat = torch.as_tensor(pre["gsat"], dtype=torch.float32, device=device)
    s = torch.as_tensor(pre["sea_level_mm"], dtype=torch.float32, device=device)
    rate = torch.diff(s, prepend=s[:1])
    X = torch.stack([gsat, torch.ones_like(gsat)], dim=-1)  # (T, 2)
    XtX = X.T @ X + ridge * torch.eye(2, dtype=torch.float32, device=device)
    theta = torch.linalg.solve(XtX, X.T @ rate)
    resid = rate - X @ theta
    sigma2 = torch.mean(resid**2)
    cov = sigma2 * torch.linalg.inv(XtX)
    return {
        "site": pre["site"],
        "theta": theta.cpu().numpy(),
        "cov": cov.cpu().numpy(),
        "sigma2": float(sigma2),
    }


def _n_future(pre: dict) -> int:
    return YEAR_END - int(pre["years"][-1])


def draws(pre: dict, fitted: dict, n_samples: int = N_SAMPLES, seed: int = 0, device="cuda") -> tuple:
    """The projection's standard normal draws, from a generator seeded
    ``(seed << 16) ^ site`` on ``device``: parameter draws (S, 2), scenario
    spread (S, 1) and residual noise (S, n_future)."""
    g = torch.Generator(device=device).manual_seed((seed << 16) ^ fitted["site"])

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32)

    return normal(n_samples, 2), normal(n_samples, 1), normal(n_samples, _n_future(pre))


def project_from_draws(pre: dict, fitted: dict, z_theta, z_scen, z_noise) -> dict:
    """Monte-Carlo projection of sea-level rise to YEAR_END from given
    standard normal draws, on the draws' device."""
    device = z_theta.device
    theta = torch.as_tensor(fitted["theta"], dtype=torch.float32, device=device)
    cov = torch.as_tensor(fitted["cov"], dtype=torch.float32, device=device)
    chol = torch.linalg.cholesky(cov + 1e-9 * torch.eye(2, dtype=torch.float32, device=device))
    thetas = theta[None, :] + z_theta @ chol.T

    last = int(pre["years"][-1])
    years_f = torch.arange(last + 1, YEAR_END + 1, device=device)
    n_f = years_f.shape[0]
    # future forcing scenario: continued warming + scenario spread
    base = 0.02 * (years_f - last) + float(pre["gsat"][-20:].mean())
    scen = base[None, :] * (1.0 + 0.3 * z_scen)
    rates = thetas[:, :1] * scen + thetas[:, 1:2]  # (S, n_f) mm/yr
    noise = float(np.sqrt(fitted["sigma2"])) * z_noise
    rise = torch.cumsum(rates + noise, dim=1)  # (S, n_f) mm above present
    return {
        "site": fitted["site"],
        "years": years_f.cpu().numpy(),
        "rise_mm": rise[:, -1].cpu().numpy(),  # at YEAR_END
        "trajectories": rise[:, :: max(1, n_f // 20)].cpu().numpy(),
    }


def project(pre: dict, fitted: dict, n_samples: int = N_SAMPLES, seed: int = 0, device="cuda") -> dict:
    """Monte-Carlo projection of sea-level rise to YEAR_END on ``device``."""
    return project_from_draws(pre, fitted, *draws(pre, fitted, n_samples, seed, device))


def postprocess(proj: dict) -> dict:
    """Quantiles of end-of-century rise (the FACTS headline numbers)."""
    q = np.quantile(proj["rise_mm"], QUANTILES)
    return {
        "site": proj["site"],
        "quantiles": dict(zip([f"p{int(100*x)}" for x in QUANTILES], q.tolist())),
        "mean_mm": float(proj["rise_mm"].mean()),
        "std_mm": float(proj["rise_mm"].std()),
    }
