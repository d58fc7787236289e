"""Config-driven optimizer factory.

The port of ``mt3d_resenc_unet_tpu/train/optimizers.py::create_optimizer``
(reference: training/optimizers/optimizer.py:5-76): every name the JAX
factory builds, after optional global-norm clipping, as an
:class:`Optimizer` of ``train/step.py``. The trainer's default path is
``step.build_optimizer`` (AdamW / SGD-nesterov).

Each name takes the keywords of its optax 0.2.6 constructor, as the JAX
factory passes them through (``keywords``). Where torch's optimizer
computes what the optax rule computes with those keywords (adam, adamw,
adamax, sgd, radam; ``torch_class``), the factory builds it. Every other
case is an :class:`OptaxRule`: the optax 0.2.6 update written in torch,
structural switches and masks included. As there, ``weight_decay`` is added
to the clipped gradient before the rule for adam, adamax, rmsprop,
adagrad, nadam, radam, yogi, sm3, sgd and fromage
(``optax.add_decayed_weights``), is the rule's own argument for adamw,
lamb, lars, lion and novograd, and is ignored by adafactor. The state of
every rule follows the parameters' dtype (optax's ``mu_dtype=None``). The
tests hold all sixteen names and every keyword against the JAX factory.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, Mapping, Optional,
                    Union)

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


def _c(x: float, t: torch.Tensor) -> float:
    """A Python scalar as it enters an optax op on ``t``: JAX's weak typing
    rounds it to ``t``'s dtype (bf16 0.999 is 1.0), where torch would keep
    it in fp32."""
    if t.dtype in (torch.float32, torch.float64):
        return x
    return float(torch.tensor(x, dtype=t.dtype))


def _wide(m, g):
    """``m`` in the wider of its and ``g``'s dtypes: XLA multiplies a
    narrower moment (``mu_dtype``, ``dtype_momentum``) by its scalar
    unrounded where the product meets an fp32 operand."""
    return m.to(torch.promote_types(m.dtype, g.dtype))


def _moment(g, m, decay):
    """optax ``update_moment``: (1 - decay) * g + decay * m."""
    return g * _c(1.0 - decay, g) + _wide(m, g) * _c(decay, m)


def _bias_corrected(m, decay, count):
    return m / _c(1.0 - decay ** count, m)


def _lr(u, h):
    """optax ``scale_by_learning_rate``: ``u * -lr`` in u's dtype."""
    return u * _c(-h["lr"], u)


def _decayed(u, p, rate):
    """optax ``add_decayed_weights``: ``u + rate * p``."""
    return u + p * _c(rate, p)


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
# schedule's value at the count before it. A mask (``mask``,
# ``weight_decay_mask``, ``trust_ratio_mask``) reaches the update as this
# parameter's bool.

def _dtype(dtype) -> Optional[torch.dtype]:
    """A dtype argument (a torch dtype, its name, or a numpy / JAX dtype)
    as a torch dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str)
                   else np.dtype(dtype).name)


def _cast(t, dtype):
    """optax ``tree.cast``: ``t`` in ``dtype`` where one is given."""
    return t if dtype is None else t.to(_dtype(dtype))


def _trace(u, state, h, key="trace"):
    """optax ``trace(decay=momentum, nesterov)``: ``t = u + m * t``, the
    update ``u + m * t`` with nesterov, else ``t``."""
    m = h["momentum"]
    t = u + state[key] * _c(m, u)
    state[key] = t
    return u + t * _c(m, u) if h["nesterov"] else t


def _rmsprop(p, g, state, h):
    """optax ``rmsprop``: ``scale_by_rms`` (``scale_by_stddev`` when
    centered; with ``bias_correction`` the moments bias-corrected), lr,
    then momentum (``trace``) over the scaled step."""
    c, decay = state["step"], h["decay"]
    nu = _moment(g * g, state["nu"], decay)
    state["nu"] = nu
    if h["bias_correction"]:
        nu = _bias_corrected(nu, decay, c)
    if h["centered"]:
        mu = _moment(g, state["mu"], decay)
        state["mu"] = mu
        if h["bias_correction"]:
            mu = _bias_corrected(mu, decay, c)
        nu = nu - mu * mu
    eps = _c(h["eps"], nu)
    if h["eps_in_sqrt"]:
        scaling = torch.rsqrt(nu + eps)
    else:
        scaling = 1.0 / (torch.sqrt(nu) + eps)
    u = _lr(scaling * g, h)
    return u if h["momentum"] is None else _trace(u, state, h)


def _rmsprop_init(p, h):
    state = {"nu": torch.full_like(p, h["initial_scale"])}
    if h["centered"]:
        state["mu"] = torch.zeros_like(p)
    if h["momentum"] is not None:
        state["trace"] = torch.zeros_like(p)
    return state


def _sgd(p, g, state, h):
    """optax ``sgd``: momentum (``trace``, with ``nesterov``) where
    ``momentum`` is not None, then lr."""
    return _lr(g if h["momentum"] is None else _trace(g, state, h), h)


def _adamax(p, g, state, h):
    """optax ``adamax``: the infinity moment ``max(|g| + eps, b2 * nu)``."""
    c = state["step"]
    mu = _moment(g, state["mu"], h["b1"])
    nu = torch.maximum(g.abs() + _c(h["eps"], g),
                       state["nu"] * _c(h["b2"], g))
    state["mu"], state["nu"] = mu, nu
    return _lr(_bias_corrected(mu, h["b1"], c) / nu, h)


def _adagrad(p, g, state, h):
    ss = g * g + state["sum_of_squares"]
    state["sum_of_squares"] = ss
    inv = torch.where(ss > 0, torch.rsqrt(ss + _c(h["eps"], ss)),
                      torch.zeros_like(ss))
    return _lr(inv * g, h)


def _adam_moments(g, state, h):
    mu = _moment(g, state["mu"], h["b1"])
    nu = _moment(g * g, state["nu"], h["b2"])
    state["mu"], state["nu"] = _cast(mu, h.get("mu_dtype")), nu
    return mu, nu


def _mu_hat(mu, g, c, h):
    """The bias-corrected first moment; with nesterov Dozat's
    ``b1 * mu_hat(c + 1) + (1 - b1) * g_hat(c)``."""
    b1 = h["b1"]
    if h.get("nesterov"):
        return (_bias_corrected(mu, b1, c + 1) * _c(b1, mu)
                + _bias_corrected(g, b1, c) * _c(1.0 - b1, g))
    return _bias_corrected(mu, b1, c)


def _adam_update(g, state, h):
    """optax ``scale_by_adam`` (``eps_root``, ``mu_dtype``, ``nesterov``)."""
    c = state["step"]
    mu, nu = _adam_moments(g, state, h)
    nu_hat = _bias_corrected(nu, h["b2"], c)
    return _mu_hat(mu, g, c, h) / (
        torch.sqrt(nu_hat + _c(h["eps_root"], nu_hat)) + _c(h["eps"], nu_hat))


def _adam(p, g, state, h):
    """optax ``adam`` / ``nadam`` (``adam(nesterov=True)``)."""
    return _lr(_adam_update(g, state, h), h)


def _adamw(p, g, state, h):
    """optax ``adamw``: the Adam step, ``+ wd * p`` where ``mask`` holds,
    then lr."""
    u = _adam_update(g, state, h)
    if h["mask"]:
        u = _decayed(u, p, h["weight_decay"])
    return _lr(u, h)


def _adam_init(p, h):
    return {"mu": torch.zeros_like(p, dtype=_dtype(h.get("mu_dtype"))),
            "nu": torch.zeros_like(p)}


def _radam(p, g, state, h):
    """optax ``radam``: the rectified Adam step where the variance's
    length ``ro`` reaches ``threshold``, else the bias-corrected first
    moment."""
    b2, c = h["b2"], state["step"]
    mu, nu = _adam_moments(g, state, h)
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = b2 ** c
    ro = ro_inf - 2.0 * c * b2t / (1.0 - b2t)
    mu_hat = _mu_hat(mu, g, c, h)
    if ro < h["threshold"]:
        return _lr(mu_hat, h)
    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
    nu_hat = _bias_corrected(nu, b2, c)
    return _lr(mu_hat * _c(r, mu_hat) / (
        torch.sqrt(nu_hat + _c(h["eps_root"], nu_hat))
        + _c(h["eps"], nu_hat)), h)


def _yogi(p, g, state, h):
    c, g2 = state["step"], g * g
    mu = _moment(g, state["mu"], h["b1"])
    nu = state["nu"] - torch.sign(state["nu"] - g2) * (1.0 - h["b2"]) * g2
    state["mu"], state["nu"] = mu, nu
    mu_hat = _bias_corrected(mu, h["b1"], c)
    nu_hat = _bias_corrected(nu, h["b2"], c)
    return _lr(mu_hat / (torch.sqrt(nu_hat + _c(h["eps_root"], nu_hat))
                         + _c(h["eps"], nu_hat)), h)


def _lamb(p, g, state, h):
    u = _adam_update(g, state, h)
    if h["mask"]:
        u = _decayed(u, p, h["weight_decay"])
    return _lr(_trust_ratio(u, p), h)


def _lars(p, g, state, h):
    """optax ``lars``: decay where ``weight_decay_mask`` holds, the trust
    ratio where ``trust_ratio_mask`` holds, lr, then momentum (optax
    ``trace``, with ``nesterov``) over the scaled step."""
    u = _decayed(g, p, h["weight_decay"]) if h["weight_decay_mask"] else g
    if h["trust_ratio_mask"]:
        u = _trust_ratio(u, p, h["trust_coefficient"], h["eps"])
    return _trace(_lr(u, h), state, h)


def _lion(p, g, state, h):
    b1, b2 = h["b1"], h["b2"]
    mu = state["mu"]
    u = torch.sign(g * _c(1.0 - b1, g) + _wide(mu, g) * _c(b1, mu))
    state["mu"] = _cast(_moment(g, state["mu"], b2), h["mu_dtype"])
    if h["mask"]:
        u = _decayed(u, p, h["weight_decay"])
    return _lr(u, h)


def _novograd_init(p, h):
    return {"mu": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype,
                                                         device=p.device)}


def _novograd(p, g, state, h):
    """Per-tensor second moment: the squared norm of the gradient."""
    sq = _l2(g) ** 2
    first = state["step"] == 1
    nu = sq if first else _moment(sq, state["nu"], h["b2"])
    u = _decayed(g / (torch.sqrt(nu + _c(h["eps_root"], nu))
                      + _c(h["eps"], nu)), p, h["weight_decay"])
    mu = u if first else state["mu"] * _c(h["b1"], u) + u
    state["mu"], state["nu"] = mu, nu
    return _lr(mu, h)


def _fromage(p, g, state, h):
    """optax ``fromage``: the trust-ratio step scaled by lr / sqrt(1 + lr^2),
    then ``(1 / sqrt(1 + lr^2) - 1) * p``. With a schedule optax's
    ``add_decayed_weights`` reads it at a count that never advances, so
    that term keeps the schedule's first value (``lr0``)."""
    lr, lr0 = h["lr"], h["lr0"]
    u = _trust_ratio(g, p, min_norm=h["min_norm"])
    u = u * _c(-(lr / (1.0 + lr ** 2) ** 0.5), u)
    return _decayed(u, p, 1.0 / (1.0 + lr0 ** 2) ** 0.5 - 1.0)


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
    inv = torch.where(accum > 0, torch.rsqrt(accum + _c(h["eps"], accum)),
                      torch.zeros_like(accum))
    nu = _moment(g * inv, state["nu"], h["momentum"])
    state["nu"] = nu
    if nd < 2:
        state["mu"] = [accum]
    else:
        state["mu"] = [torch.amax(accum, dim=[j for j in range(nd) if j != i])
                       for i in range(nd)]
    return _lr(nu, h)


def factored_dims(shape, h):
    """optax ``factorized._factored_dims``: the two largest dims by
    ``np.argsort`` (ties in its order), or None (also when not
    ``factored``)."""
    if not h.get("factored", True) or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < h["min_dim_size_to_factor"]:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor_init(p, h):
    dims = factored_dims(tuple(p.shape), h)
    shape = list(p.shape)
    state = ({"v": torch.zeros_like(p)} if dims is None else
             {"v_row": p.new_zeros(shape[:dims[1]] + shape[dims[1] + 1:]),
              "v_col": p.new_zeros(shape[:dims[0]] + shape[dims[0] + 1:])})
    if h["momentum"] is not None:
        state["ema"] = torch.zeros_like(p, dtype=_dtype(h["dtype_momentum"]))
    return state


def _adafactor(p, g, state, h):
    """optax ``adafactor``: factored second moments (``factored``), the
    block-RMS clip (``clipping_threshold``), lr, the parameter's RMS scale,
    at least 1e-3 (``multiply_by_parameter_scale``), momentum (an EMA kept
    in ``dtype_momentum``), ``+ weight_decay_rate * p`` where
    ``weight_decay_mask`` holds, descent."""
    rate = 1.0 - (state["step"] - h["decay_offset"]) ** -h["decay_rate"]
    g2 = g * g + _c(h["eps"], g)
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
    if h["clipping_threshold"] is not None:
        u = u / torch.clamp(_rms(u) / h["clipping_threshold"], min=1.0)
    u = u * _c(h["lr"], u)
    if h["multiply_by_parameter_scale"]:
        rms = _rms(p)
        u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
    if h["momentum"] is not None:
        u = _moment(u, state["ema"], h["momentum"])
        state["ema"] = _cast(u, h["dtype_momentum"])
    if h["weight_decay_rate"] is not None and h["weight_decay_mask"]:
        u = _decayed(u, p, h["weight_decay_rate"])
    return -u


def _zeros(*names):
    return lambda p, h: {n: torch.zeros_like(p) for n in names}


def _full(value, *names):
    return lambda p, h: {n: torch.full_like(p, h[value]) for n in names}


_ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
             nesterov=False)
# defaults: optax 0.2.6's keywords of each rule with its defaults, then (in
# _INTERNAL) the constants the optax function fixes
_RULES: Dict[str, tuple] = {
    "sgd": (dict(momentum=0.9, nesterov=True),
            lambda p, h: ({} if h["momentum"] is None
                          else {"trace": torch.zeros_like(p)}), _sgd),
    "adamax": (dict(b1=0.9, b2=0.999, eps=1e-8), _zeros("mu", "nu"),
               _adamax),
    "adam": (_ADAM, _adam_init, _adam),
    "adamw": (dict(_ADAM, mask=None), _adam_init, _adamw),
    "nadam": (dict(_ADAM, nesterov=True), _adam_init, _adam),
    "radam": (dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0,
                   nesterov=False), _zeros("mu", "nu"), _radam),
    "rmsprop": (dict(decay=0.9, eps=1e-8, initial_scale=0.0,
                     eps_in_sqrt=True, centered=False, momentum=None,
                     nesterov=False, bias_correction=False),
                _rmsprop_init, _rmsprop),
    "adagrad": (dict(initial_accumulator_value=0.1, eps=1e-7),
                _full("initial_accumulator_value", "sum_of_squares"),
                _adagrad),
    "yogi": (dict(b1=0.9, b2=0.999, eps=1e-3, eps_root=0.0,
                  initial_accumulator_value=1e-6),
             _full("initial_accumulator_value", "mu", "nu"), _yogi),
    "lamb": (dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, mask=None),
             _zeros("mu", "nu"), _lamb),
    "lars": (dict(weight_decay_mask=True, trust_coefficient=0.001, eps=0.0,
                  trust_ratio_mask=True, momentum=0.9, nesterov=False),
             _zeros("trace"), _lars),
    "lion": (dict(b1=0.9, b2=0.99, mu_dtype=None, mask=None),
             lambda p, h: {"mu": torch.zeros_like(
                 p, dtype=_dtype(h["mu_dtype"]))}, _lion),
    "novograd": (dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0),
                 _novograd_init, _novograd),
    "fromage": (dict(min_norm=1e-6, lr0=None), lambda p, h: {}, _fromage),
    "sm3": (dict(momentum=0.9, eps=1e-8), _sm3_init, _sm3),
    "adafactor": (dict(min_dim_size_to_factor=128, decay_rate=0.8,
                       decay_offset=0, multiply_by_parameter_scale=True,
                       clipping_threshold=1.0, momentum=None,
                       dtype_momentum=torch.float32, weight_decay_rate=None,
                       eps=1e-30, factored=True, weight_decay_mask=None),
                  _adafactor_init, _adafactor),
}
_INTERNAL = {"yogi": ("eps_root", "initial_accumulator_value"),
             "fromage": ("min_norm", "lr0"), "sm3": ("eps",)}
_MASKS = ("mask", "weight_decay_mask", "trust_ratio_mask")


def _mask_of(mask, i: int) -> bool:
    """Parameter ``i``'s entry of a mask: a list of bools (one a
    parameter), or None / a bool for all (None: no mask, every one)."""
    if isinstance(mask, (list, tuple)):
        return bool(mask[i])
    return True if mask is None else bool(mask)


class OptaxRule(torch.optim.Optimizer):
    """An optax rule by ``name`` (a key of ``_RULES``), with optax 0.2.6's
    keywords of its constructor as keyword arguments over optax's defaults,
    its structural switches included (rmsprop's ``centered`` / ``momentum``
    / ``nesterov`` / ``bias_correction`` / ``eps_in_sqrt``, adafactor's
    ``factored`` / ``momentum`` / ``multiply_by_parameter_scale`` / ...,
    ``mu_dtype``, ``nesterov``); another keyword raises ``TypeError``, as
    optax does. A mask is one bool a parameter (``create_optimizer``
    resolves optax's name-keyed form), or None / a bool for all.
    ``weight_decay`` is added to the gradient before the rule for the names
    the JAX factory chains after ``add_decayed_weights``, and is the rule's
    own for adamw, lamb, lars, lion and novograd. The state is per
    parameter (tensors in the parameter's dtype, or ``mu_dtype`` /
    ``dtype_momentum``; a list of tensors for sm3; the update count
    ``step``), so ``state_dict`` / ``load_state_dict`` checkpoint it as
    torch's own, and ``tools/from_jax.py`` fills it from optax's."""

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
            for i, p in enumerate(group["params"]):
                if p.grad is None:
                    continue
                h = dict(group, **{k: _mask_of(group[k], i) for k in _MASKS
                                   if k in group})
                g = p.grad
                if decayed and h["weight_decay"] and p.dtype == torch.float32:
                    # one fused multiply-add, as torch's own optimizers
                    # and the jitted optax chain round it in fp32
                    g = torch.add(g, p, alpha=h["weight_decay"])
                elif decayed and h["weight_decay"]:
                    g = _decayed(g, p, h["weight_decay"])
                state = self.state[p]
                if not state:
                    state.update(init(p, h), step=0)
                state["step"] += 1
                p.add_(update(p, g, state, h))
        return loss

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """torch's, but a state tensor keeps the dtype it was saved in
        (``mu_dtype``, ``dtype_momentum``): torch casts each to its
        parameter's."""
        super().load_state_dict(state_dict)
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(ids, params):
            for key, value in state_dict["state"].get(i, {}).items():
                if (isinstance(value, torch.Tensor)
                        and value.dtype != self.state[p][key].dtype):
                    self.state[p][key] = value.to(p.device, copy=True)


NAMES = tuple(sorted(_RULES))


def keywords(name: str) -> Dict[str, Any]:
    """optax 0.2.6's keywords of ``name`` that the JAX factory passes
    through, with their defaults (sgd: the factory's momentum 0.9 and
    nesterov; fromage: none)."""
    n = name.lower()
    return {k: v for k, v in _RULES[n][0].items()
            if k not in _INTERNAL.get(n, ())}


def torch_class(name: str, dtype: torch.dtype = torch.float32,
                **kwargs: Any):
    """The ``torch.optim`` class that computes ``name`` with these optax
    keywords on parameters of ``dtype``, or None where only an
    :class:`OptaxRule` does: 16-bit parameters (optax rounds every scalar
    to their dtype, torch's optimizers keep it in fp32), a nonzero
    ``eps_root``, a ``mu_dtype``, ``nesterov`` or a mask for adam / adamw,
    radam with another ``threshold``."""
    n = name.lower()
    kw = {**keywords(n), **kwargs}
    if n not in _TORCH or dtype != torch.float32:
        return None
    plain = n in ("adamax", "sgd") or (
        kw["eps_root"] == 0.0 and not kw["nesterov"]
        and kw.get("mu_dtype") is None and kw.get("mask") is None
        and kw.get("threshold", 5.0) == 5.0)
    return _TORCH[n] if plain else None


def optax_fields(name: str, p: torch.Tensor, **kwargs: Any) -> tuple:
    """The optax state fields the rule ``name`` keeps for parameter ``p``
    with these keywords (an :class:`OptaxRule`'s state of ``p``, ``step``
    apart): optax's layout, whichever optimizer the port builds."""
    defaults = _RULES[name.lower()][0]
    h = {**defaults, **{k: v for k, v in kwargs.items() if k in defaults}}
    return tuple(_RULES[name.lower()][1](torch.empty_like(p, device="meta"),
                                         h))


def state_for(optimizer: torch.optim.Optimizer,
              state: Mapping[str, Any]) -> Dict[str, Any]:
    """One parameter's state in optax's layout (``mu``, ``nu``, ``trace``,
    ...; ``step`` the update count), as ``tools/from_jax.py`` carries it,
    -> the layout of ``optimizer``, built by :func:`create_optimizer`. An
    :class:`OptaxRule` keeps optax's. torch's Adam / AdamW / RAdam keep
    ``mu``, ``nu`` as ``exp_avg``, ``exp_avg_sq`` and the count as a tensor
    ``step``; Adamax its ``exp_inf`` (optax's infinity moment, eps inside
    the max); SGD optax's nesterov ``trace`` as ``momentum_buffer`` (torch's
    ``buf = m*buf + g`` and update ``g + m*buf`` are optax's)."""
    if isinstance(optimizer, OptaxRule):
        return dict(state)
    if isinstance(optimizer, torch.optim.SGD):
        return ({"momentum_buffer": state["trace"]} if "trace" in state
                else {})
    if not isinstance(optimizer, tuple(_TORCH.values())):
        raise TypeError(f"no optax layout for {type(optimizer).__name__}")
    second = ("exp_inf" if isinstance(optimizer, torch.optim.Adamax)
              else "exp_avg_sq")
    return {"step": torch.tensor(float(state["step"])),
            "exp_avg": state["mu"], second: state["nu"]}


def _resolve_masks(kw: Dict[str, Any], named) -> None:
    """optax's masks (a dict of parameter names to bool, or a callable on
    the named parameters giving one) -> one bool a parameter, in place."""
    for key in _MASKS:
        mask = kw.get(key)
        if mask is None or isinstance(mask, bool):
            continue
        if named is None:
            raise TypeError(f"{key} by name needs the named parameters: "
                            "pass model.named_parameters()")
        if callable(mask):
            mask = mask(named)
        missing = set(named) - set(mask)
        if missing:
            raise KeyError(f"{key} lacks {sorted(missing)[:5]}")
        kw[key] = [bool(mask[n]) for n in named]


def create_optimizer(params, name: str,
                     learning_rate: Union[float, Schedule],
                     weight_decay: float = 0.0,
                     grad_clip_norm: Optional[float] = None,
                     **kwargs: Any) -> Optimizer:
    """Build an optimizer by name, as the JAX factory does, with optax
    0.2.6's keywords of that name (:func:`keywords`). ``params`` are
    parameters, or ``(name, parameter)`` pairs (``model.named_parameters()``)
    where a mask is given by name. ``learning_rate`` is a float or a
    schedule of the update count. SGD defaults to momentum 0.9 with
    nesterov and takes only those two (the JAX factory drops the rest);
    fromage takes none (it drops them all); sm3 takes a float only
    (``optax.sm3`` negates its learning rate, which a schedule refuses with
    ``TypeError``). A name and keywords ``torch.optim`` computes
    (:func:`torch_class`) build it; every other case an :class:`OptaxRule`.
    Dtype keywords (``mu_dtype``, ``dtype_momentum``) take a torch dtype or
    its name."""
    n = name.lower()
    if n not in NAMES:
        raise ValueError(f"Unknown optimizer '{name}'. Known: {list(NAMES)}")
    if n == "sm3" and callable(learning_rate):
        raise TypeError("optimizer 'sm3' takes a float learning rate, not a "
                        "schedule (optax.sm3 scales by -learning_rate)")
    allowed = keywords(n)
    if n in ("sgd", "fromage"):
        kwargs = {k: v for k, v in kwargs.items() if k in allowed}
    unknown = set(kwargs) - set(allowed)
    if unknown:
        raise TypeError(f"{n}: unexpected arguments {sorted(unknown)}")
    kw = {**allowed, **kwargs}
    schedule = (learning_rate if callable(learning_rate)
                else lambda count: float(learning_rate))
    params = list(params)
    named = None
    if params and isinstance(params[0], tuple):
        named = dict(params)
        params = list(named.values())
    _resolve_masks(kw, named)
    lr0 = schedule(0)
    cls = torch_class(n, params[0].dtype if params else torch.float32,
                      **kwargs)
    if cls is torch.optim.SGD:
        momentum = kw["momentum"] or 0.0
        opt = cls(params, lr=lr0, weight_decay=weight_decay,
                  momentum=momentum, nesterov=bool(kw["nesterov"])
                  and momentum > 0)
    elif cls is not None:
        opt = cls(params, lr=lr0, weight_decay=weight_decay,
                  betas=(kw["b1"], kw["b2"]), eps=kw["eps"])
    elif n == "fromage":
        opt = OptaxRule(params, n, lr0, weight_decay, lr0=lr0)
    elif n == "adafactor":
        opt = OptaxRule(params, n, lr0, **kw)
    else:
        opt = OptaxRule(params, n, lr0, weight_decay, **kw)
    return Optimizer(opt, schedule, grad_clip_norm)
