"""PNDM (PLMS) schedule, Open-Sora-Plan v1.1.0's sampler: the
``magcache_tpu.schedulers.pndm`` schedule, host numpy only.

The reference's OSP pipeline uses diffusers' ``PNDMScheduler`` for v110
(``videosys/pipelines/open_sora_plan/pipeline_open_sora_plan.py:302-306``)
with ``skip_prk_steps`` semantics. Faithful transcription of
``PNDMScheduler.set_timesteps`` + ``step_plms``:

- the iteration list DUPLICATES the second timestep
  (``plms_timesteps = concat(ts[:-1], ts[-2:-1], ts[-1:])[::-1]`` — n+1
  model calls for n inference steps);
- counter 0: eps is recorded, the plain transfer runs, and the incoming
  sample is stashed as ``cur_sample``;
- counter 1 (the duplicated timestep): the new eps is averaged with the
  recorded one, the FIRST transfer is REDONE from ``cur_sample`` (a Heun
  corrector) with the same (t, t_prev) pair, and the eps history is NOT
  appended;
- counter 2: ``(3 e_t - e_prev)/2``; counter 3: ``(23 e - 16 e' + 5 e'')/12``;
  counter >=4: the 4th-order Adams-Bashforth ``(55, -59, 37, -9)/24``;
- the prev-sample transfer is DDIM-form (``_get_prev_sample``)::

    x_prev = (abar_prev/abar_t)^0.5 * x - (abar_prev - abar_t) /
             (abar_t^0.5 * ((1-abar_prev)^0.5 + (abar_prev(1-abar_t)/abar_t)^0.5)) * e'

  with ``abar_prev = final_alpha_cumprod = abar[0]`` when the previous
  timestep falls below zero (PNDM's ``set_alpha_to_one=False`` default).

Everything is host-precomputed into per-iteration (c_x, c_e) pairs, a
[n+1, 4] epsilon weight table over (e_cur, h0, h1, h2), and push/use-cur
flags, so the device loop (``core.sampler.sample_pndm``) reads one row a step.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PNDMSchedule"]

_AB4 = (55 / 24, -59 / 24, 37 / 24, -9 / 24)


@dataclasses.dataclass(frozen=True)
class PNDMSchedule:
    timesteps: np.ndarray    # f32[n+1] — model-call timesteps (2nd duplicated)
    c_x: np.ndarray          # f32[n+1]
    c_e: np.ndarray          # f32[n+1]
    eps_weights: np.ndarray  # f32[n+1, 4]: weight of e_cur, h0, h1, h2
    push_eps: np.ndarray     # f32[n+1]: 1 = append e_cur to the history
    use_cur: np.ndarray      # f32[n+1]: 1 = transfer from cur_sample (Heun)

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, *, train_steps: int = 1000,
               beta_start: float = 0.0001, beta_end: float = 0.02,
               beta_schedule: str = "scaled_linear") -> "PNDMSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, train_steps,
                                dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                train_steps, dtype=np.float64) ** 2
        else:
            raise ValueError(beta_schedule)
        abar = np.cumprod(1.0 - betas)

        # diffusers "leading" spacing: arange(n) * (train//n), ascending,
        # then the plms list duplicates the second-to-last before reversal
        ratio = train_steps // num_steps
        base = (np.arange(num_steps) * ratio).round().astype(int)
        iter_ts = np.concatenate(
            [base[:-1], base[-2:-1], base[-1:]])[::-1]     # n+1, descending

        n1 = len(iter_ts)
        c_x = np.zeros(n1)
        c_e = np.zeros(n1)
        w = np.zeros((n1, 4))
        push = np.ones(n1)
        use_cur = np.zeros(n1)
        for counter, t in enumerate(iter_ts):
            t_prev = t - ratio
            if counter == 0:
                w[counter] = (1.0, 0.0, 0.0, 0.0)
            elif counter == 1:
                # duplicated timestep: Heun redo of the first transfer from
                # cur_sample with the averaged eps; history not appended
                t_prev, t = t, t + ratio
                w[counter] = (0.5, 0.5, 0.0, 0.0)
                push[counter] = 0.0
                use_cur[counter] = 1.0
            elif counter == 2:
                w[counter] = (1.5, -0.5, 0.0, 0.0)
            elif counter == 3:
                w[counter] = (23 / 12, -16 / 12, 5 / 12, 0.0)
            else:
                w[counter] = _AB4
            a_t = abar[t]
            # final_alpha_cumprod = abar[0] (set_alpha_to_one=False default)
            a_prev = abar[t_prev] if t_prev >= 0 else abar[0]
            c_x[counter] = np.sqrt(a_prev / a_t)
            denom = np.sqrt(a_t) * (np.sqrt(1 - a_prev)
                                    + np.sqrt(a_prev * (1 - a_t) / a_t))
            c_e[counter] = -(a_prev - a_t) / denom
        return PNDMSchedule(timesteps=iter_ts.astype(np.float32),
                            c_x=c_x.astype(np.float32),
                            c_e=c_e.astype(np.float32),
                            eps_weights=w.astype(np.float32),
                            push_eps=push.astype(np.float32),
                            use_cur=use_cur.astype(np.float32))
