"""ReLeQ agent networks (paper §2.7): shared-LSTM actor-critic (torch port
of ``repro.core.agent``).

    state embedding -> LSTM(128)  ("first hidden layer for both networks")
        policy head: FC 128 -> FC 128 -> |bitwidths| softmax
        value head:  FC 128 -> FC 64  -> 1

The LSTM carry persists across the layer-steps of one episode and resets
between episodes.  Params are the reference's dict (``x @ w + b``
layouts), so ``convert.agent_params_from_numpy`` carries JAX params over
unchanged.  The gates split as i, f, g, o, with +1 inside the forget
gate's sigmoid, as the reference's ``_lstm_step``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device

HIDDEN = 128


def _dense(gen, n_in, n_out, scale=None):
    s = scale if scale is not None else (2.0 / n_in) ** 0.5
    return {"w": torch.randn((n_in, n_out), generator=gen) * s,
            "b": torch.zeros((n_out,))}


def init_agent(seed: int, state_dim: int, num_actions: int, device=None):
    """Draws from a CPU ``torch.Generator`` seeded with ``seed`` (the same
    params on the CPU and the card), then moves to ``device``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {
        "lstm": {
            "wx": torch.randn((state_dim, 4 * HIDDEN), generator=gen)
            * (1.0 / state_dim) ** 0.5,
            "wh": torch.randn((HIDDEN, 4 * HIDDEN), generator=gen)
            * (1.0 / HIDDEN) ** 0.5,
            "b": torch.zeros((4 * HIDDEN,)),
        },
        "pi1": _dense(gen, HIDDEN, 128),
        "pi2": _dense(gen, 128, 128),
        "pi_head": _dense(gen, 128, num_actions, scale=0.01),
        "v1": _dense(gen, HIDDEN, 128),
        "v2": _dense(gen, 128, 64),
        "v_head": _dense(gen, 64, 1, scale=0.01),
    }
    return {k: {n: t.to(device) for n, t in p.items()} for k, p in params.items()}


def lstm_carry(batch: int, device=None):
    device = resolve_device(device)
    return (torch.zeros((batch, HIDDEN), device=device),
            torch.zeros((batch, HIDDEN), device=device))


def _lstm_step(p, carry, x):
    h, c = carry
    z = x @ p["wx"] + h @ p["wh"] + p["b"]
    i, f, g, o = torch.split(z, HIDDEN, dim=-1)
    c2 = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return (h2, c2), h2


def _ff(p, x):
    return x @ p["w"] + p["b"]


def agent_step(params, carry, state, use_lstm: bool = True):
    """One step.  state: (B, state_dim) -> (carry', logits (B, A), value (B,))."""
    if use_lstm:
        carry2, h = _lstm_step(params["lstm"], carry, state)
    else:  # MLP ablation (paper §2.7: LSTM converges ~1.33× faster)
        carry2, h = carry, torch.tanh(state @ params["lstm"]["wx"][:, :HIDDEN])
    hp = torch.relu(_ff(params["pi1"], h))
    hp = torch.relu(_ff(params["pi2"], hp))
    logits = _ff(params["pi_head"], hp)
    hv = torch.relu(_ff(params["v1"], h))
    hv = torch.relu(_ff(params["v2"], hv))
    value = _ff(params["v_head"], hv)[..., 0]
    return carry2, logits, value


def rollout_logits(params, states, use_lstm: bool = True):
    """Teacher-forced pass over stored trajectories (a Python loop over T
    where the reference scans).

    states: (B, T, S) -> logits (B, T, A), values (B, T).
    """
    B, T = states.shape[:2]
    carry = lstm_carry(B, states.device)
    logits, values = [], []
    for t in range(T):
        carry, lg, v = agent_step(params, carry, states[:, t], use_lstm)
        logits.append(lg)
        values.append(v)
    return torch.stack(logits, 1), torch.stack(values, 1)
