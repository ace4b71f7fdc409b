"""Brownian-bridge schedules and sampler coefficients, in numpy.

A copy of ``bbdm_tpu/models/schedules.py`` (the JAX package's
``models/__init__.py`` imports jax, so the port cannot import it there):

    x_t = (1 - m_t) * x0 + m_t * y + sqrt(var_t) * eps,   var_t = 2 (m_t - m_t^2) max_var

The reverse posterior step is folded into per-step linear coefficients,
computed in float64 and stored as float32; the port's sampler consumes them as
they are. Tests hold every array equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BridgeSchedule:
    """Forward-bridge schedule arrays, all shape [T], float32."""

    num_timesteps: int
    m_t: np.ndarray
    m_tminus: np.ndarray
    variance_t: np.ndarray
    variance_tminus: np.ndarray
    variance_t_tminus: np.ndarray
    posterior_variance_t: np.ndarray


@dataclasses.dataclass(frozen=True)
class SamplerCoeffs:
    """Per-sampling-step coefficients, all shape [S], float32:
    x_next = a_xt * x_t + a_x0 * x0_hat + a_y * y + sigma * eps."""

    steps: np.ndarray  # int32 [S]: timestep fed to the UNet at step i
    a_xt: np.ndarray
    a_x0: np.ndarray
    a_y: np.ndarray
    sigma: np.ndarray
    m_t: np.ndarray
    sigma_fwd: np.ndarray  # sqrt(variance_t) at the current step


def make_m_schedule(num_timesteps: int, mt_type: str) -> np.ndarray:
    """m_t schedule: 'linear' linspace(0.001, 0.999, T); 'sin' the normalised
    1.0075**t exponential with m_T forced to 0.999."""
    T = num_timesteps
    if mt_type == "linear":
        m_t = np.linspace(0.001, 0.999, T, dtype=np.float64)
    elif mt_type == "sin":
        m_t = 1.0075 ** np.linspace(0, T, T, dtype=np.float64)
        m_t = m_t / m_t[-1]
        m_t[-1] = 0.999
    else:
        raise NotImplementedError(f"mt_type {mt_type!r}")
    return m_t


def make_bridge_schedule(
    num_timesteps: int, mt_type: str = "linear", max_var: float = 1.0
) -> BridgeSchedule:
    m_t = make_m_schedule(num_timesteps, mt_type)
    m_tminus = np.append(0.0, m_t[:-1])

    variance_t = 2.0 * (m_t - m_t**2) * max_var
    variance_tminus = np.append(0.0, variance_t[:-1])
    variance_t_tminus = variance_t - variance_tminus * ((1.0 - m_t) / (1.0 - m_tminus)) ** 2
    posterior_variance_t = variance_t_tminus * variance_tminus / variance_t

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return BridgeSchedule(
        num_timesteps=num_timesteps,
        m_t=f32(m_t),
        m_tminus=f32(m_tminus),
        variance_t=f32(variance_t),
        variance_tminus=f32(variance_tminus),
        variance_t_tminus=f32(variance_t_tminus),
        posterior_variance_t=f32(posterior_variance_t),
    )


def make_sampling_steps(
    num_timesteps: int,
    skip_sample: bool,
    sample_type: str,
    sample_step: int,
) -> np.ndarray:
    """Descending timestep grid ending at 0 ('linear' or 'cosine' spacing)."""
    T = num_timesteps
    if not skip_sample:
        return np.arange(T - 1, -1, -1, dtype=np.int64)
    if sample_type == "linear":
        if sample_step < 3:
            raise ValueError(f"linear skip sampling needs sample_step >= 3, got {sample_step}")
        midsteps = np.arange(T - 1, 1, step=-((T - 1) / (sample_step - 2)), dtype=np.float64)
        midsteps = midsteps.astype(np.int64)  # trunc toward zero
        return np.concatenate([midsteps, np.array([1, 0], dtype=np.int64)])
    if sample_type == "cosine":
        steps = np.linspace(0, T, num=sample_step + 1, dtype=np.float64)
        steps = (np.cos(steps / T * np.pi) + 1.0) / 2.0 * T
        steps = np.clip(np.round(steps).astype(np.int64), 0, T - 1)
        if steps[-1] != 0:
            steps = np.append(steps, 0)
        # nt == t is an identity update: drop the duplicates rounding makes
        steps = steps[np.concatenate(([True], np.diff(steps) != 0))]
        return steps
    raise NotImplementedError(f"sample_type {sample_type!r}")


def make_sampler_coeffs(
    schedule_num_timesteps: int,
    mt_type: str,
    max_var: float,
    steps: np.ndarray,
    eta: float = 1.0,
) -> SamplerCoeffs:
    """Fold the reverse-bridge posterior into per-step linear coefficients
    (float64 arithmetic, float32 result). The terminal t == 0 step returns
    x0_hat: (a_xt, a_x0, a_y, sigma) = (0, 1, 0, 0)."""
    m = make_m_schedule(schedule_num_timesteps, mt_type)
    var = 2.0 * (m - m**2) * max_var

    steps = np.asarray(steps, dtype=np.int64)
    S = len(steps)
    a_xt = np.zeros(S, dtype=np.float64)
    a_x0 = np.zeros(S, dtype=np.float64)
    a_y = np.zeros(S, dtype=np.float64)
    sigma = np.zeros(S, dtype=np.float64)

    for i in range(S):
        t = steps[i]
        if t == 0:
            a_xt[i], a_x0[i], a_y[i], sigma[i] = 0.0, 1.0, 0.0, 0.0
            continue
        nt = steps[i + 1]
        m_t, m_nt = m[t], m[nt]
        var_t, var_nt = var[t], var[nt]
        sigma2_t = (var_t - var_nt * (1.0 - m_t) ** 2 / (1.0 - m_nt) ** 2) * var_nt / var_t
        sigma2_t = max(sigma2_t, 0.0)
        A = np.sqrt(max(var_nt - sigma2_t, 0.0) / var_t)
        a_xt[i] = A
        a_x0[i] = (1.0 - m_nt) - A * (1.0 - m_t)
        a_y[i] = m_nt - A * m_t
        sigma[i] = eta * np.sqrt(sigma2_t)

    f32 = lambda a: np.asarray(a, dtype=np.float32)
    return SamplerCoeffs(
        steps=np.asarray(steps, dtype=np.int32),
        a_xt=f32(a_xt),
        a_x0=f32(a_x0),
        a_y=f32(a_y),
        sigma=f32(sigma),
        m_t=f32(m[steps]),
        sigma_fwd=f32(np.sqrt(var[steps])),
    )
