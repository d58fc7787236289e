"""Network planning: the immutable architecture spec the port's modules
consume.

A copy of ``mt3d_resenc_unet_tpu/core/plan.py`` (``NetworkPlan``,
``TaskHead``, ``plan_from_autoconfig``, ``plan_from_manual_config`` and the
helpers they call):
that package's ``__init__`` imports flax, so the port cannot import it. The
autoconfiguration reproduces the nnU-Net-v2 ResEnc-M heuristics of the
reference (utils.py:334-445, build_network_from_config.py:39-80).
``use_pallas_conv`` keeps its name so plans read the same in both
packages; in the port it selects the hand-written CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Tuple


def compute_pool_and_conv_plan(
    spacing: Sequence[float],
    patch_size: Sequence[int],
    min_feature_map_size: int = 4,
    max_numpool: int = 999999,
):
    """Derive per-stage pool and conv kernel schedules from the patch size.

    Semantics match the reference planner (utils.py:334-402):

    Returns ``(num_pool_per_axis, pool_kernel_sizes, conv_kernel_sizes,
    padded_patch_size, must_be_divisible_by)`` where ``pool_kernel_sizes``
    includes the leading identity stage ``(1,)*dim`` and ``conv_kernel_sizes``
    includes the trailing bottleneck kernel ``(3,)*dim``.
    """
    dim = len(spacing)
    cur_spacing = [float(s) for s in spacing]
    cur_size = [int(p) for p in patch_size]

    pool_kernel_sizes = [(1,) * dim]
    conv_kernel_sizes = []
    num_pool_per_axis = [0] * dim
    kernel = [1] * dim

    while True:
        valid = [i for i in range(dim) if cur_size[i] >= 2 * min_feature_map_size]
        if not valid:
            break
        min_sp = min(cur_spacing[i] for i in valid)
        valid = [i for i in valid if cur_spacing[i] / min_sp < 2]
        valid = [i for i in valid if num_pool_per_axis[i] < max_numpool]
        if not valid:
            break

        # An axis graduates to kernel 3 once its spacing is within 2x of the
        # finest spacing; it never goes back to 1.
        finest = min(cur_spacing)
        for d in range(dim):
            if kernel[d] != 3 and cur_spacing[d] / finest < 2:
                kernel[d] = 3

        pool = [1] * dim
        for v in valid:
            pool[v] = 2
            num_pool_per_axis[v] += 1
            cur_spacing[v] *= 2
            cur_size[v] = math.ceil(cur_size[v] / 2)

        pool_kernel_sizes.append(tuple(pool))
        conv_kernel_sizes.append(tuple(kernel))

    must_div = tuple(2 ** n for n in num_pool_per_axis)
    padded = pad_shape_to_divisible(patch_size, must_div)
    conv_kernel_sizes.append((3,) * dim)

    return (
        tuple(num_pool_per_axis),
        tuple(pool_kernel_sizes),
        tuple(conv_kernel_sizes),
        padded,
        must_div,
    )


def pad_shape_to_divisible(shape: Sequence[int], must_div) -> Tuple[int, ...]:
    """Round each axis up to the next multiple of ``must_div`` (identity when
    already divisible; reference: utils.py:405-426)."""
    if not isinstance(must_div, (tuple, list)):
        must_div = [must_div] * len(shape)
    out = []
    for s, m in zip(shape, must_div):
        r = s % m
        out.append(s if r == 0 else s + (m - r))
    return tuple(out)


def default_blocks_per_stage(num_stages: int) -> Tuple[int, ...]:
    """Stage block counts 1, 3, 4 then 6 for every deeper stage
    (reference: utils.py:428-445)."""
    table = {0: 1, 1: 3, 2: 4}
    return tuple(table.get(i, 6) for i in range(num_stages))





def _as_per_stage_kernels(kernel_sizes, num_stages: int, dim: int) -> Tuple[Tuple[int, ...], ...]:
    """Normalize kernel_sizes config (int | [int] | [[int]*dim]*stages) to a
    tuple of per-stage per-axis tuples."""
    if isinstance(kernel_sizes, int):
        return tuple((kernel_sizes,) * dim for _ in range(num_stages))
    kernel_sizes = list(kernel_sizes)
    if all(isinstance(k, int) for k in kernel_sizes):
        if len(kernel_sizes) == dim and num_stages == dim and dim > 1:
            # ambiguous (could be one per-axis kernel OR per-stage scalars);
            # resolved as per-stage scalars like the reference — warn when
            # the two readings build different networks so a config typo is
            # not silent
            if len(set(kernel_sizes)) > 1:
                import warnings
                warnings.warn(
                    f"kernel_sizes={kernel_sizes} is ambiguous with "
                    f"num_stages == dim == {dim}: interpreting as PER-STAGE "
                    "scalar kernels. Use nested per-stage lists "
                    "(e.g. [[3,3,3], ...]) to be explicit.", stacklevel=3)
            return tuple((int(k),) * dim for k in kernel_sizes)
        if len(kernel_sizes) == 1:
            return tuple((int(kernel_sizes[0]),) * dim for _ in range(num_stages))
        if len(kernel_sizes) == num_stages:
            return tuple((int(k),) * dim for k in kernel_sizes)
        raise ValueError(
            f"kernel_sizes of length {len(kernel_sizes)} does not match num_stages={num_stages}"
        )
    out = []
    for k in kernel_sizes:
        if isinstance(k, int):
            out.append((k,) * dim)
        else:
            kk = tuple(int(x) for x in k)
            if len(kk) != dim:
                raise ValueError(f"per-stage kernel {kk} does not have {dim} axes")
            out.append(kk)
    if len(out) == 1:
        out = out * num_stages
    if len(out) != num_stages:
        raise ValueError(
            f"kernel_sizes has {len(out)} stages, expected {num_stages}"
        )
    return tuple(out)


def _as_per_stage_strides(strides, num_stages: int, dim: int) -> Tuple[Tuple[int, ...], ...]:
    if isinstance(strides, int):
        return tuple((strides,) * dim for _ in range(num_stages))
    out = []
    for s in strides:
        if isinstance(s, int):
            out.append((s,) * dim)
        else:
            ss = tuple(int(x) for x in s)
            if len(ss) != dim:
                raise ValueError(f"per-stage stride {ss} does not have {dim} axes")
            out.append(ss)
    if len(out) != num_stages:
        raise ValueError(f"strides has {len(out)} stages, expected {num_stages}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TaskHead:
    """Per-task decoder head spec (reference: tasks/*.yaml `targets` and
    build_network_from_config.py:261-277)."""

    name: str
    channels: int
    activation: str = "none"  # none | sigmoid | softmax

    def __post_init__(self):
        if self.activation.lower() not in ("none", "sigmoid", "softmax"):
            raise ValueError(f"Unknown activation: {self.activation}")


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Immutable architecture description consumed by the torch model.

    Field for field the JAX package's plan, so one config builds the same
    network in both packages.
    """

    in_channels: int
    dim: int
    num_stages: int
    features_per_stage: Tuple[int, ...]
    n_blocks_per_stage: Tuple[int, ...]
    n_conv_per_stage_decoder: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, ...], ...]
    strides: Tuple[Tuple[int, ...], ...]
    tasks: Tuple[TaskHead, ...]

    basic_encoder_block: str = "BasicBlockD"   # BasicBlockD | BottleneckBlockD | ConvBlock
    basic_decoder_block: str = "ConvBlock"     # ConvBlock | ResidualBlock
    bottleneck_block: str = "BasicBlockD"
    bottleneck_channels: Optional[Tuple[int, ...]] = None

    conv_bias: bool = False
    norm_eps: float = 1e-5
    norm_affine: bool = False
    nonlin: str = "leaky_relu"
    nonlin_negative_slope: float = 1e-2
    dropout_p: float = 0.0

    do_stem: bool = True
    stem_channels: Optional[int] = None
    squeeze_excitation: bool = False
    squeeze_excitation_reduction_ratio: float = 1.0 / 16.0
    stochastic_depth_p: float = 0.0
    deep_supervision: bool = False
    # Training-only in the JAX package (block rematerialization); the
    # port's eval forward ignores it.
    remat: bool = True
    # Route the convs and upsamples of the kernel classes to the
    # hand-written CUDA kernels (models/blocks.py Conv).
    use_pallas_conv: bool = False

    # The patch size the plan was derived for (padded to pool divisibility).
    patch_size: Tuple[int, ...] = ()
    model_name: str = "Model"

    def __post_init__(self):
        ns = self.num_stages
        for field, want in (
            ("features_per_stage", ns),
            ("n_blocks_per_stage", ns),
            ("kernel_sizes", ns),
            ("strides", ns),
            ("n_conv_per_stage_decoder", ns - 1),
        ):
            got = len(getattr(self, field))
            if got != want:
                raise ValueError(f"{field} has {got} entries, expected {want}")
        if not self.tasks:
            raise ValueError("NetworkPlan requires at least one task head")

    # ------------------------------------------------------------------
    @property
    def task_names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tasks)

    @property
    def stem_width(self) -> int:
        return self.stem_channels or self.features_per_stage[0]

    def downsample_factor(self) -> Tuple[int, ...]:
        total = [1] * self.dim
        for st in self.strides:
            for d in range(self.dim):
                total[d] *= st[d]
        return tuple(total)

    def validate_patch(self, patch_size: Sequence[int]) -> None:
        factors = self.downsample_factor()
        for p, f in zip(patch_size, factors):
            if p % f != 0:
                raise ValueError(
                    f"patch size {tuple(patch_size)} not divisible by total "
                    f"downsampling {factors}"
                )

    # ------------------------------------------------------------------
    def estimate_activation_voxels(self, patch_size: Sequence[int]) -> int:
        """Analytic activation footprint in voxels-times-channels, mirroring
        the per-block ``compute_conv_feature_map_size`` accounting of the
        reference (encoder.py:160-170, resblocks.py:116-132)."""
        size = list(patch_size)
        total = 0
        if self.do_stem:
            total += self.stem_width * math.prod(size)
        for s in range(self.num_stages):
            size = [i // j for i, j in zip(size, self.strides[s])]
            c = self.features_per_stage[s]
            vox = math.prod(size)
            # each BasicBlockD holds two conv outputs (+ projection on first)
            total += self.n_blocks_per_stage[s] * 2 * c * vox + c * vox
        # decoder roughly mirrors encoder skips
        size = list(patch_size)
        for s in range(self.num_stages - 1):
            size_s = [i // j for i, j in zip(size, self.strides[s])] if s else size
            c = self.features_per_stage[s]
            total += len(self.tasks) * (self.n_conv_per_stage_decoder[s] + 2) * c * math.prod(size_s)
        return total


def plan_from_autoconfig(
    patch_size: Sequence[int],
    in_channels: int,
    tasks: Sequence[TaskHead],
    spacing: Optional[Sequence[float]] = None,
    base_features: int = 32,
    max_features: int = 512,
    min_feature_map_size: int = 4,
    model_name: str = "Model",
    **overrides: Any,
) -> NetworkPlan:
    """nnU-Net-style autoconfiguration
    (reference: build_network_from_config.py:39-80)."""
    dim = len(patch_size)
    if spacing is None:
        spacing = (1.0,) * dim
    (num_pool, pool_kernels, conv_kernels, padded, _must) = compute_pool_and_conv_plan(
        spacing, patch_size, min_feature_map_size=min_feature_map_size
    )
    num_stages = len(pool_kernels)
    features = tuple(min(base_features * 2 ** i, max_features) for i in range(num_stages))
    return NetworkPlan(
        in_channels=in_channels,
        dim=dim,
        num_stages=num_stages,
        features_per_stage=features,
        n_blocks_per_stage=default_blocks_per_stage(num_stages),
        n_conv_per_stage_decoder=(1,) * (num_stages - 1),
        kernel_sizes=conv_kernels,
        strides=pool_kernels,
        tasks=tuple(tasks),
        patch_size=tuple(padded),
        model_name=model_name,
        **overrides,
    )


def plan_from_manual_config(
    model_config: Mapping[str, Any],
    patch_size: Sequence[int],
    in_channels: int,
    tasks: Sequence[TaskHead],
    model_name: str = "Model",
) -> NetworkPlan:
    """Build a plan from an explicit per-stage spec, validating required keys
    like the reference (build_network_from_config.py:82-162)."""
    required = (
        "basic_encoder_block",
        "basic_decoder_block",
        "bottleneck_block",
        "features_per_stage",
        "num_stages",
        "n_blocks_per_stage",
        "kernel_sizes",
        "n_conv_per_stage_decoder",
        "strides",
    )
    missing = [k for k in required if k not in model_config]
    if missing:
        raise ValueError(
            "autoconfigure=False but required model_config keys are missing: "
            + ", ".join(missing)
        )
    dim = len(patch_size)
    num_stages = int(model_config["num_stages"])
    features = model_config["features_per_stage"]
    if isinstance(features, int):
        features = [features * 2 ** i for i in range(num_stages)]
    features = tuple(int(f) for f in features)

    bottleneck_block = str(model_config["bottleneck_block"])
    bottleneck_channels = model_config.get("bottleneck_channels")
    if bottleneck_block == "BottleneckBlockD":
        if bottleneck_channels is None:
            bottleneck_channels = tuple(f // 4 for f in features)
        elif isinstance(bottleneck_channels, int):
            bottleneck_channels = (bottleneck_channels,) * num_stages
        else:
            bottleneck_channels = tuple(int(c) for c in bottleneck_channels)
    else:
        bottleneck_channels = None

    squeeze_excitation = bool(model_config.get("squeeze_excitation", False))
    stem_channels = model_config.get("stem_channels")
    if isinstance(stem_channels, str):  # YAML "None" artifacts
        stem_channels = None

    return NetworkPlan(
        in_channels=in_channels,
        dim=dim,
        num_stages=num_stages,
        features_per_stage=features,
        n_blocks_per_stage=tuple(int(b) for b in _listify(model_config["n_blocks_per_stage"], num_stages)),
        n_conv_per_stage_decoder=tuple(
            int(b) for b in _listify(model_config["n_conv_per_stage_decoder"], num_stages - 1)
        ),
        kernel_sizes=_as_per_stage_kernels(model_config["kernel_sizes"], num_stages, dim),
        strides=_as_per_stage_strides(model_config["strides"], num_stages, dim),
        tasks=tuple(tasks),
        basic_encoder_block=_canonical_block(str(model_config["basic_encoder_block"]), "encoder"),
        basic_decoder_block=_canonical_block(str(model_config["basic_decoder_block"]), "decoder"),
        bottleneck_block=bottleneck_block,
        bottleneck_channels=bottleneck_channels,
        conv_bias=bool(model_config.get("conv_bias", False)),
        dropout_p=float((model_config.get("dropout_op_kwargs") or {}).get("p", 0.0)),
        do_stem=bool(model_config.get("do_stem", True)),
        stem_channels=stem_channels,
        squeeze_excitation=squeeze_excitation,
        squeeze_excitation_reduction_ratio=(
            float(model_config.get("squeeze_excitation_reduction_ratio", 1.0 / 16.0))
            if not isinstance(model_config.get("squeeze_excitation_reduction_ratio"), str)
            else 1.0 / 16.0
        ),
        stochastic_depth_p=float(model_config.get("stochastic_depth_p", 0.0)),
        deep_supervision=bool(model_config.get("deep_supervision", False)),
        patch_size=tuple(int(p) for p in patch_size),
        model_name=model_name,
    )


def _canonical_block(name: str, role: str) -> str:
    """Map config block names to canonical ones. The reference accepts
    'ResidualBlock'/'ConvBlock' for decoders and 'BasicBlockD'/'ResidualBlock'
    for encoders (encoder.py:72-79, decoder.py:68,102)."""
    aliases = {
        "residualblock": "ResidualBlock",
        "basicblockd": "BasicBlockD",
        "bottleneckblockd": "BottleneckBlockD",
        "bottleneckd": "BottleneckBlockD",
        "convblock": "ConvBlock",
    }
    canon = aliases.get(name.lower())
    if canon is None:
        raise ValueError(f"Unknown {role} block type: {name}")
    if role == "encoder" and canon == "ResidualBlock":
        canon = "BasicBlockD"
    return canon


def _listify(v, n: int):
    if isinstance(v, int):
        return [v] * n
    return list(v)
