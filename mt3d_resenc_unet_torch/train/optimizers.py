"""Config-driven optimizer factory.

The port of ``mt3d_resenc_unet_tpu/train/optimizers.py::create_optimizer``
(reference: training/optimizers/optimizer.py:5-76): every name the JAX
factory builds, after optional global-norm clipping, as an
:class:`Optimizer` of ``train/step.py``. The trainer's default path is
``step.build_optimizer`` (AdamW / SGD-nesterov).

Where torch's optimizer computes what the optax rule computes (adam, adamw,
adamax, sgd, radam), the factory builds it. Every other name is an
:class:`OptaxRule`: the optax 0.2.6 update written in torch, with the
defaults the JAX factory calls it with. As there, ``weight_decay`` is added
to the clipped gradient before the rule for adam, adamax, rmsprop,
adagrad, nadam, radam, yogi, sm3, sgd and fromage
(``optax.add_decayed_weights``), is the rule's own argument for adamw,
lamb, lars, lion and novograd, and is ignored by adafactor. The tests hold
all sixteen names against the JAX factory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from .step import Optimizer, Schedule

_TORCH = {
    "adam": torch.optim.Adam,
    "adamw": torch.optim.AdamW,
    "adamax": torch.optim.Adamax,
    "sgd": torch.optim.SGD,
    "radam": torch.optim.RAdam,
}
# the names the JAX factory chains after optax.add_decayed_weights
_DECAYED = ("adam", "adamax", "rmsprop", "adagrad", "nadam", "radam", "yogi",
            "sm3", "sgd", "fromage")


def _moment(g, m, decay):
    """optax ``update_moment``: (1 - decay) * g + decay * m."""
    return g * (1.0 - decay) + m * decay


def _bias_corrected(m, decay, count):
    return m / (1.0 - decay ** count)


def _l2(x):
    """The L2 norm of a tensor, summed in float64: torch's fp32
    ``vector_norm`` on the CPU drifts by ~1e-3 over a few million
    elements, where XLA's and CUDA's tree sums stay within ~1e-7."""
    return torch.linalg.vector_norm(x, dtype=torch.float64).to(x.dtype)


def _norm(x, min_norm=0.0):
    """optax ``numerics.safe_norm``: the L2 norm, or ``min_norm`` where the
    norm is at most ``min_norm``."""
    n = _l2(x)
    return torch.where(n <= min_norm, torch.full_like(n, min_norm), n)


def _trust_ratio(u, p, coefficient=1.0, eps=0.0, min_norm=0.0):
    """optax ``scale_by_trust_ratio``: u * coefficient * |p| / (|u| + eps),
    or u where either norm is 0."""
    pn, un = _norm(p, min_norm), _norm(u, min_norm)
    ratio = pn * coefficient / (un + eps)
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(ratio), ratio)
    return u * ratio


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


# ---------------------------------------------------------------- the rules
# Each rule is (defaults, init(p, group) -> state, update(p, g, state,
# group) -> the step added to p). ``state["step"]`` is the count of updates
# including this one (optax's ``count_inc``); ``group["lr"]`` is the
# schedule's value at the count before it.

def _rmsprop(p, g, state, h):
    """optax ``rmsprop``: eps inside the root."""
    nu = _moment(g * g, state["nu"], h["decay"])
    state["nu"] = nu
    return torch.rsqrt(nu + h["eps"]) * g * -h["lr"]


def _adagrad(p, g, state, h):
    ss = g * g + state["sum_of_squares"]
    state["sum_of_squares"] = ss
    inv = torch.where(ss > 0, torch.rsqrt(ss + h["eps"]),
                      torch.zeros_like(ss))
    return inv * g * -h["lr"]


def _adam_moments(g, state, h):
    mu = _moment(g, state["mu"], h["b1"])
    nu = _moment(g * g, state["nu"], h["b2"])
    state["mu"], state["nu"] = mu, nu
    return mu, nu


def _nadam(p, g, state, h):
    """optax ``adam(nesterov=True)`` (Dozat's Nesterov Adam)."""
    b1, c = h["b1"], state["step"]
    mu, nu = _adam_moments(g, state, h)
    mu_hat = (_bias_corrected(mu, b1, c + 1) * b1
              + _bias_corrected(g, b1, c) * (1.0 - b1))
    nu_hat = _bias_corrected(nu, h["b2"], c)
    return mu_hat / (torch.sqrt(nu_hat + h["eps_root"]) + h["eps"]) * -h["lr"]


def _yogi(p, g, state, h):
    c, g2 = state["step"], g * g
    mu = _moment(g, state["mu"], h["b1"])
    nu = state["nu"] - torch.sign(state["nu"] - g2) * (1.0 - h["b2"]) * g2
    state["mu"], state["nu"] = mu, nu
    mu_hat = _bias_corrected(mu, h["b1"], c)
    nu_hat = _bias_corrected(nu, h["b2"], c)
    return mu_hat / (torch.sqrt(nu_hat + h["eps_root"]) + h["eps"]) * -h["lr"]


def _lamb(p, g, state, h):
    c = state["step"]
    mu, nu = _adam_moments(g, state, h)
    u = (_bias_corrected(mu, h["b1"], c)
         / (torch.sqrt(_bias_corrected(nu, h["b2"], c) + h["eps_root"])
            + h["eps"]))
    u = u + p * h["weight_decay"]
    return _trust_ratio(u, p) * -h["lr"]


def _lars(p, g, state, h):
    """optax ``lars``: decay, the trust ratio, lr, then momentum (optax
    ``trace``) over the scaled step."""
    u = g + p * h["weight_decay"]
    u = _trust_ratio(u, p, h["trust_coefficient"], h["eps"]) * -h["lr"]
    state["trace"] = u + state["trace"] * h["momentum"]
    return state["trace"]


def _lion(p, g, state, h):
    b1, b2 = h["b1"], h["b2"]
    u = torch.sign(g * (1.0 - b1) + state["mu"] * b1)
    state["mu"] = _moment(g, state["mu"], b2)
    return (u + p * h["weight_decay"]) * -h["lr"]


def _novograd_init(p, h):
    return {"mu": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype,
                                                         device=p.device)}


def _novograd(p, g, state, h):
    """Per-tensor second moment: the squared norm of the gradient."""
    sq = _l2(g) ** 2
    first = state["step"] == 1
    nu = sq if first else _moment(sq, state["nu"], h["b2"])
    u = g / (torch.sqrt(nu + h["eps_root"]) + h["eps"]) + p * h["weight_decay"]
    mu = u if first else state["mu"] * h["b1"] + u
    state["mu"], state["nu"] = mu, nu
    return mu * -h["lr"]


def _fromage(p, g, state, h):
    """optax ``fromage``: the trust-ratio step scaled by lr / sqrt(1 + lr^2),
    then ``(1 / sqrt(1 + lr^2) - 1) * p``. With a schedule optax's
    ``add_decayed_weights`` reads it at a count that never advances, so
    that term keeps the schedule's first value (``lr0``)."""
    lr, lr0 = h["lr"], h["lr0"]
    u = _trust_ratio(g, p, min_norm=h["min_norm"])
    u = u * -(lr / (1.0 + lr ** 2) ** 0.5)
    return u + p * (1.0 / (1.0 + lr0 ** 2) ** 0.5 - 1.0)


def _sm3_init(p, h):
    return {"mu": [torch.zeros(s, dtype=p.dtype, device=p.device)
                   for s in p.shape],
            "nu": torch.zeros_like(p)}


def _sm3(p, g, state, h):
    """optax ``scale_by_sm3(b1=momentum, b2=1)``: one accumulator per
    dimension, the elementwise bound their minimum."""
    nd = g.dim()
    mus = [m.reshape([1] * i + [m.shape[0]] + [1] * (nd - i - 1))
           for i, m in enumerate(state["mu"])]
    bound = mus[0]
    for m in mus[1:]:
        bound = torch.minimum(bound, m)
    accum = g * g + bound
    inv = torch.where(accum > 0, torch.rsqrt(accum + h["eps"]),
                      torch.zeros_like(accum))
    nu = _moment(g * inv, state["nu"], h["momentum"])
    state["nu"] = nu
    if nd < 2:
        state["mu"] = [accum]
    else:
        state["mu"] = [torch.amax(accum, dim=[j for j in range(nd) if j != i])
                       for i in range(nd)]
    return nu * -h["lr"]


def factored_dims(shape, h):
    """optax ``factorized._factored_dims``: the two largest dims by
    ``np.argsort`` (ties in its order), or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < h["min_dim_size_to_factor"]:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor_init(p, h):
    dims = factored_dims(tuple(p.shape), h)
    if dims is None:
        return {"v": torch.zeros_like(p)}
    d1, d0 = dims
    shape = list(p.shape)
    return {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
            "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:])}


def _adafactor(p, g, state, h):
    """optax ``adafactor``: factored second moments, block-RMS clip, lr,
    the parameter's RMS scale (at least 1e-3), descent."""
    rate = 1.0 - (state["step"] - h["decay_offset"]) ** -h["decay_rate"]
    g2 = g * g + h["eps"]
    dims = factored_dims(tuple(p.shape), h)
    if dims is None:
        v = state["v"] * rate + g2 * (1.0 - rate)
        state["v"] = v
        u = g * v ** -0.5
    else:
        d1, d0 = dims
        v_row = state["v_row"] * rate + torch.mean(g2, dim=d0) * (1.0 - rate)
        v_col = state["v_col"] * rate + torch.mean(g2, dim=d1) * (1.0 - rate)
        state["v_row"], state["v_col"] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / torch.mean(v_row, dim=reduced_d1,
                                         keepdim=True)) ** -0.5
        u = (g * row_factor.unsqueeze(d0)
             * (v_col ** -0.5).unsqueeze(d1))
    u = u / torch.clamp(_rms(u) / h["clipping_threshold"], min=1.0)
    rms = _rms(p)
    scale = torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
    return -(u * h["lr"] * scale)


def _zeros(*names):
    return lambda p, h: {n: torch.zeros_like(p) for n in names}


def _full(value, *names):
    return lambda p, h: {n: torch.full_like(p, h[value]) for n in names}


_RULES: Dict[str, tuple] = {
    "rmsprop": (dict(decay=0.9, eps=1e-8, initial_scale=0.0),
                _full("initial_scale", "nu"), _rmsprop),
    "adagrad": (dict(initial_accumulator_value=0.1, eps=1e-7),
                _full("initial_accumulator_value", "sum_of_squares"),
                _adagrad),
    "nadam": (dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
              _zeros("mu", "nu"), _nadam),
    "yogi": (dict(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0,
                  initial_accumulator_value=1e-6),
             _full("initial_accumulator_value", "mu", "nu"), _yogi),
    "lamb": (dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0),
             _zeros("mu", "nu"), _lamb),
    "lars": (dict(trust_coefficient=0.001, eps=0.0, momentum=0.9),
             _zeros("trace"), _lars),
    "lion": (dict(b1=0.9, b2=0.99), _zeros("mu"), _lion),
    "novograd": (dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0),
                 _novograd_init, _novograd),
    "fromage": (dict(min_norm=1e-6, lr0=None), lambda p, h: {}, _fromage),
    "sm3": (dict(momentum=0.9, eps=1e-8), _sm3_init, _sm3),
    "adafactor": (dict(min_dim_size_to_factor=128, decay_rate=0.8,
                       decay_offset=0, clipping_threshold=1.0, eps=1e-30),
                  _adafactor_init, _adafactor),
}


class OptaxRule(torch.optim.Optimizer):
    """An optax rule that torch lacks, by ``name`` (a key of ``_RULES``),
    with its scalar hyperparameters as keyword arguments over optax's
    defaults (optax's structural switches, such as rmsprop's momentum or
    adafactor's, are not ported: passing one raises ``TypeError``).
    ``weight_decay`` is added to the gradient before the rule for the names
    the JAX factory chains after ``add_decayed_weights``, and is the rule's
    own for lamb, lars, lion and novograd. The state is per parameter
    (tensors, a list of tensors for sm3, and the update count ``step``), so
    ``state_dict`` / ``load_state_dict`` checkpoint it as torch's own."""

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str,
                 lr: float, weight_decay: float = 0.0, **hyper: Any):
        if name not in _RULES:
            raise ValueError(f"no optax rule '{name}'")
        defaults = dict(_RULES[name][0])
        unknown = set(hyper) - set(defaults)
        if unknown:
            raise TypeError(f"{name}: unexpected arguments {sorted(unknown)}")
        defaults.update(hyper, lr=lr, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.name = name

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], float]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        _, init, update = _RULES[self.name]
        decayed = self.name in _DECAYED
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if decayed and group["weight_decay"]:
                    # one fused multiply-add, as torch's own optimizers
                    # and the jitted optax chain round it
                    g = torch.add(g, p, alpha=group["weight_decay"])
                state = self.state[p]
                if not state:
                    state.update(init(p, group), step=0)
                state["step"] += 1
                p.add_(update(p, g, state, group))
        return loss


NAMES = tuple(sorted(set(_TORCH) | set(_RULES)))


def create_optimizer(params: Iterable[torch.nn.Parameter], name: str,
                     learning_rate: Union[float, Schedule],
                     weight_decay: float = 0.0,
                     grad_clip_norm: Optional[float] = None,
                     **kwargs: Any) -> Optimizer:
    """Build an optimizer by name, as the JAX factory does.
    ``learning_rate`` is a float or a schedule of the update count. SGD
    defaults to momentum 0.9 with nesterov; fromage takes no arguments (the
    JAX factory passes none); sm3 takes a float only (``optax.sm3`` negates
    its learning rate, which a schedule refuses with ``TypeError``)."""
    n = name.lower()
    if n not in NAMES:
        raise ValueError(f"Unknown optimizer '{name}'. Known: {list(NAMES)}")
    if n == "sm3" and callable(learning_rate):
        raise TypeError("optimizer 'sm3' takes a float learning rate, not a "
                        "schedule (optax.sm3 scales by -learning_rate)")
    schedule = (learning_rate if callable(learning_rate)
                else lambda count: float(learning_rate))
    params = list(params)
    lr0 = schedule(0)
    if n in _TORCH:
        if n == "sgd":
            kwargs.setdefault("momentum", 0.9)
            kwargs.setdefault("nesterov", True)
        opt = _TORCH[n](params, lr=lr0, weight_decay=weight_decay, **kwargs)
    elif n == "fromage":
        opt = OptaxRule(params, n, lr0, weight_decay, lr0=lr0)
    elif n == "adafactor":
        opt = OptaxRule(params, n, lr0, **kwargs)
    else:
        opt = OptaxRule(params, n, lr0, weight_decay, **kwargs)
    return Optimizer(opt, schedule, grad_clip_norm)
