"""YAML configuration system of the port.

A copy of ``mt3d_resenc_unet_tpu/core/config.py``: the same five-section
schema (``tr_setup``, ``tr_config``, ``model_config``, ``dataset_config``,
``inference_config``; reference: configuration/config_manager.py:13-97) and
the same defaults, so one config file drives both packages. Differences:

* a config file is read by the port's own YAML reader
  (``core/yaml_load.py``, the values and types of ``yaml.safe_load``),
  so a machine without pyyaml reads the same task files;
* ``use_pallas_conv: null`` (auto) follows the device ``build_plan`` is
  given (``resolve_device``: the card unless the caller names the CPU):
  the hand-written CUDA kernels on the card, their plain versions on the
  CPU;
* ``augment_on_device: true`` runs ``data/augment_device.py`` inside the
  port's training step, as the JAX package runs its own;
* the TPU-only keys (``mesh_shape``, ``dp_axis``, ``donate_state``,
  ``remat``) are read as the JAX package reads them; the port's trainer
  ignores them (``remat``: the flagship step at batch 2 fits the H100).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..parallel.distributed import local_device_index
from .plan import NetworkPlan, TaskHead, plan_from_autoconfig, plan_from_manual_config
from .yaml_load import safe_load

_SECTIONS = ("tr_setup", "tr_config", "model_config", "dataset_config", "inference_config")


def resolve_device(device=None) -> torch.device:
    """The device an entry point of the port runs on. ``None`` or
    ``"cuda"`` is this rank's CUDA card (``cuda:{LOCAL_RANK %
    device_count}``, the first card single-process), and raises
    ``RuntimeError`` where there is none: the port never falls back to the
    CPU on its own. ``"cpu"`` (or a ``torch.device``) is taken as the
    caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_device_index())
    return dev


def set_precision() -> None:
    """The port's one conv and matmul precision, set by every entry point
    that runs on the card (``Trainer``, ``ZarrInferenceEngine``,
    ``chip_smoke.py``, ``tools/profile_step.py``), so that what is timed is what a user runs:
    fp32 convs and matmuls in full fp32 (TF32 off: the fp32 reference
    model, the plain versions of the kernels), and bf16 and fp16 matmuls
    that add cuBLAS's split-K partials in fp32, as the JAX package's fp32
    accumulation does (the stem GEMM's K is every voxel)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


class ConfigManager:
    """Single object handed to model/dataset/trainer/inference builders."""

    def __init__(self, config_file: Optional[str] = None, config_dict: Optional[Mapping[str, Any]] = None,
                 verbose: bool = False):
        if config_dict is None:
            if config_file is None:
                raise ValueError("Provide config_file or config_dict")
            with open(config_file, "r", encoding="utf-8") as f:
                config = safe_load(f)
        else:
            config = dict(config_dict)
        self.config_file = config_file

        missing = [s for s in _SECTIONS if s not in config]
        if missing:
            raise ValueError(
                f"Config is missing sections: {missing}. Expected the five-section "
                f"schema {list(_SECTIONS)} (legacy 'tr_params'/'inference_params' "
                f"configs must be migrated)."
            )

        self.tr_info: Dict[str, Any] = dict(config["tr_setup"] or {})
        self.tr_configs: Dict[str, Any] = dict(config["tr_config"] or {})
        self.model_config: Dict[str, Any] = dict(config["model_config"] or {})
        self.dataset_config: Dict[str, Any] = dict(config["dataset_config"] or {})
        self.inference_config: Dict[str, Any] = dict(config["inference_config"] or {})

        # ---- tr_setup ------------------------------------------------
        t = self.tr_info
        self.model_name: str = t.get("model_name", "Model")
        self.vram_max: float = float(t.get("vram_max", 16))
        self.autoconfigure: bool = bool(t.get("autoconfigure", True))
        self.tr_val_split: float = float(t.get("tr_val_split", 0.95))
        self.dilate_label: bool = bool(t.get("dilate_label", False))
        self.ckpt_out_base: Path = Path(t.get("ckpt_out_base", "./checkpoints/"))
        ckpt_path = t.get("checkpoint_path", None)
        self.checkpoint_path: Optional[Path] = Path(ckpt_path) if ckpt_path else None
        self.load_weights_only: bool = bool(t.get("load_weights_only", False))
        self.tensorboard_log_dir: str = t.get("tensorboard_log_dir", "./tensorboard_logs/")
        self.seed: int = int(t.get("seed", 0))
        self.ckpt_keep: int = int(t.get("ckpt_keep", 10))
        # save a checkpoint every N epochs; 0 disables per-epoch checkpoints
        # (the final weights dump still happens). Default 1 = the reference's
        # checkpoint-every-epoch behavior (reference: train.py:249-254).
        self.ckpt_interval_epochs: int = int(t.get("ckpt_interval_epochs", 1))
        # write the {model_name}_final weights dump after training (the
        # reference's final state_dict save, train.py:339)
        self.save_final: bool = bool(t.get("save_final", True))
        # timestamped phase markers (mining/epoch boundaries) to stderr
        self.phase_log: bool = bool(t.get("phase_log", False))

        # ---- tr_config -----------------------------------------------
        c = self.tr_configs
        self.optimizer: str = c.get("optimizer", "AdamW")
        self.initial_lr: float = float(c.get("initial_lr", 1e-3))
        self.weight_decay: float = float(c.get("weight_decay", 0))
        self.train_patch_size: Tuple[int, ...] = tuple(c.get("patch_size", [192, 192, 192]))
        self.train_batch_size: int = int(c.get("batch_size", 2))
        self.gradient_accumulation: int = int(c.get("gradient_accumulation", 1))
        self.max_steps_per_epoch: int = int(c.get("max_steps_per_epoch", 500))
        self.max_val_steps_per_epoch: int = int(c.get("max_val_steps_per_epoch", 25))
        self.train_num_dataloader_workers: int = int(c.get("num_dataloader_workers", 4))
        self.max_epoch: int = int(c.get("max_epoch", 500))
        self.ignore_label = c.get("ignore_label", None)
        self.loss_only_on_label: bool = bool(c.get("loss_only_on_label", False))
        # knobs with no reference counterpart; dp_axis, mesh_shape and
        # donate_state are read for the JAX package's configs and unused here
        self.compute_dtype: str = c.get("compute_dtype", "bfloat16")
        self.param_dtype: str = c.get("param_dtype", "float32")
        self.dp_axis: str = c.get("dp_axis", "data")
        self.mesh_shape = c.get("mesh_shape", None)  # None -> all devices on dp
        self.grad_clip_norm: float = float(c.get("grad_clip_norm", 3.0))
        self.donate_state: bool = bool(c.get("donate_state", True))
        # the hand-written CUDA kernels of the conv and upsample classes;
        # null = on where there is a CUDA device (build_plan)
        self.use_pallas_conv: Optional[bool] = c.get("use_pallas_conv", None)
        self.remat: bool = bool(c.get("remat", True))
        # compact wire format: samples cross host->device as stored dtypes
        # (uint8 masks, uint16-encoded normals, bf16 image) and are decoded
        # on the device by the step — 2-4x fewer H2D bytes, bit-identical
        # decode (data/dataset.py wire mode + train/step.py decode_wire)
        self.wire_format: bool = bool(c.get("wire_format", True))
        # the stochastic sample pipeline inside the step on the device
        # (data/augment_device.py) instead of on the host (data/augment.py)
        self.augment_on_device: bool = bool(c.get("augment_on_device", False))

        # ---- dataset_config -------------------------------------------
        d = self.dataset_config
        self.min_labeled_ratio: float = float(d.get("min_labeled_ratio", 0.1))
        self.min_bbox_percent: float = float(d.get("min_bbox_percent", 0.95))
        self.use_cache: bool = bool(d.get("use_cache", True))
        # hold whole training volumes in host RAM when their total stored
        # bytes fit the budget ("auto"); per-sample reads then cost a slice
        # copy instead of tensorstore chunk decode (~4x on 1-core hosts).
        # true forces caching, false disables. No reference counterpart for
        # training (the reference re-opens stores per sample; its inference
        # load_all is the analog — inference.py:32-33).
        rcv = d.get("ram_cache_volumes", "auto")
        if not isinstance(rcv, bool):
            rcv = str(rcv).lower()
            if rcv in ("true", "1", "yes"):
                rcv = True
            elif rcv in ("false", "0", "no"):
                rcv = False
            elif rcv != "auto":
                # a typo like "always" must not silently disable the cache
                raise ValueError(
                    f"dataset_config.ram_cache_volumes must be a bool or "
                    f"'auto', got {d.get('ram_cache_volumes')!r}")
        self.ram_cache_volumes = rcv
        self.ram_cache_budget_gb: float = float(
            d.get("ram_cache_budget_gb", 4.0))
        self.cache_folder: Path = Path(d.get("cache_folder", d.get("cache_file", "patch_cache")))
        self.in_channels: int = int(d.get("in_channels", 1))
        self.tasks: Dict[str, Dict[str, Any]] = dict(d.get("targets", {}) or {})
        self.volume_paths: List[Dict[str, str]] = list(d.get("volume_paths", []) or [])
        if not self.tasks:
            raise ValueError("dataset_config.targets must define at least one task")

        self.out_channels: Tuple[int, ...] = tuple(
            int(info["channels"]) for info in self.tasks.values()
        )
        self.num_tasks: int = len(self.tasks)

        # ---- inference_config ------------------------------------------
        i = self.inference_config
        self.infer_checkpoint_path = i.get("checkpoint_path", None)
        # when not explicitly set, the inference patch follows the TRAIN patch
        # *after* autoconfig pads it (build_plan below); a default-config
        # inference must not rebuild the plan with the unpadded size
        self._infer_patch_explicit: bool = "patch_size" in i
        self.infer_patch_size: Tuple[int, ...] = tuple(i.get("patch_size", self.train_patch_size))
        self.infer_batch_size: int = int(i.get("batch_size", self.train_batch_size))
        self.infer_output_path: str = i.get("output_path", "./outputs")
        self.infer_input_path: Optional[str] = i.get("input_path", None)
        self.infer_input_format: str = i.get("input_format", "zarr")
        self.infer_output_format: str = i.get("output_format", "zarr")
        self.infer_output_dtype: str = i.get("output_type", "np.uint8")
        self.infer_overlap: float = float(i.get("overlap", 0.25))
        self.infer_load_all: bool = bool(i.get("load_all", False))
        self.infer_num_dataloader_workers: int = int(i.get("num_dataloader_workers", 4))
        self.load_strict: bool = bool(i.get("load_strict", True))
        self.infer_normalization: str = i.get("normalization", "standardize")
        # nnU-Net-style Gaussian-weighted patch blending (the reference
        # intended this — inference/helpers.py:8-91 — but left it unwired and
        # used uniform count averaging; here it is first-class).
        self.infer_gaussian_blend: bool = bool(i.get("gaussian_blend", True))
        self.infer_gaussian_sigma_scale: float = float(i.get("gaussian_sigma_scale", 1.0 / 8))
        # Host-RAM ceiling for accumulation slabs. Volumes whose full-plane
        # rolling slab would exceed it are processed in disjoint (z, y-band)
        # tiles (scroll-scale stores; the reference's per-patch zarr RMW was
        # memory-bounded but ~100x slower — inference.py:135-157).
        self.infer_host_ram_budget_gb: float = float(
            i.get("host_ram_budget_gb", 8.0))
        # Whole-volume ON-DEVICE accumulation + finalize + quantize for
        # volumes whose accumulators fit in HBM: only raw input bytes go up
        # and quantized finals come down — the fast path on hosts with a slow
        # device link (infer/engine.py _run_model_pass_device). "auto" uses
        # it for single-process runs within the budget; true forces, false
        # disables.
        self.infer_device_accumulate = i.get("device_accumulate", "auto")
        self.infer_device_accum_budget_gb: float = float(
            i.get("device_accum_budget_gb", 6.0))
        # device_accumulate writes only {tgt}_final by default; set
        # write_sums to also persist {tgt}_sum/{tgt}_count for
        # --postprocess_only reuse (always written by the host paths)
        self.infer_write_sums: bool = bool(i.get("write_sums", False))

        # output targets: accept dict {name: {channels, activation}}, a list of
        # names (resolved against training targets), or the reference's quirky
        # list-of-single-key-dicts form (tasks/example.yaml:87-92).
        self.infer_output_targets: Dict[str, Dict[str, Any]] = self._resolve_output_targets(
            i.get("output_targets", None), i.get("targets", None)
        )

        if verbose:
            self._print_summary()

    # ------------------------------------------------------------------
    def _resolve_output_targets(self, output_targets, targets_section) -> Dict[str, Dict[str, Any]]:
        def _from_targets_section(sec):
            out: Dict[str, Dict[str, Any]] = {}
            if isinstance(sec, Mapping):
                for k, v in sec.items():
                    out[k] = dict(v or {})
            elif isinstance(sec, list):
                for item in sec:
                    if isinstance(item, Mapping):
                        for k, v in item.items():
                            out[k] = dict(v or {})
            return out

        explicit = _from_targets_section(targets_section)
        if isinstance(output_targets, Mapping):
            return {k: dict(v or {}) for k, v in output_targets.items()}
        if isinstance(output_targets, list) and output_targets:
            resolved = {}
            for name in output_targets:
                if name in explicit:
                    resolved[name] = explicit[name]
                elif name in self.tasks:
                    resolved[name] = dict(self.tasks[name])
                # names not trained with are silently skipped (matching the
                # reference's intent of partial outputs via load_strict=False)
            if resolved:
                return resolved
        if explicit:
            return {k: v for k, v in explicit.items() if k in self.tasks or "channels" in v}
        # default: all training targets
        return {k: dict(v) for k, v in self.tasks.items()}

    # ------------------------------------------------------------------
    def task_heads(self) -> Tuple[TaskHead, ...]:
        return tuple(
            TaskHead(
                name=name,
                channels=int(info["channels"]),
                activation=str(info.get("activation", "none") or "none"),
            )
            for name, info in self.tasks.items()
        )

    def build_plan(self, device=None) -> NetworkPlan:
        """Derive the static NetworkPlan from this config
        (reference: builders/build_network_from_config.py:39-162) for the
        model on ``device`` (``resolve_device``)."""
        heads = self.task_heads()
        use_pallas = self.use_pallas_conv
        if use_pallas is None:
            # auto: the CUDA kernels on the card, their plain versions on
            # the CPU
            use_pallas = resolve_device(device).type == "cuda"
        if self.autoconfigure:
            overrides = {}
            for key in ("squeeze_excitation", "conv_bias",
                        "stochastic_depth_p", "do_stem", "deep_supervision",
                        "squeeze_excitation_reduction_ratio"):
                if key in self.model_config:
                    overrides[key] = self.model_config[key]
            plan = plan_from_autoconfig(
                patch_size=self.train_patch_size,
                in_channels=self.in_channels,
                tasks=heads,
                model_name=self.model_config.get("model_name", self.model_name),
                **overrides,
            )
        else:
            plan = plan_from_manual_config(
                self.model_config,
                patch_size=self.train_patch_size,
                in_channels=self.in_channels,
                tasks=heads,
                model_name=self.model_config.get("model_name", self.model_name),
            )
        plan = dataclasses.replace(plan, use_pallas_conv=bool(use_pallas),
                                   remat=self.remat)
        # The autoconfig planner pads the patch to pooling divisibility
        # (reference computes final_patch_size but never reconciles the
        # dataset with it — SURVEY.md §2.6/§7.3.7); keep dataset and model
        # agreed on the padded size.
        if plan.patch_size and tuple(plan.patch_size) != self.train_patch_size:
            print(f"[config] patch_size {self.train_patch_size} padded to "
                  f"{tuple(plan.patch_size)} for pooling divisibility")
            if not self._infer_patch_explicit \
                    and self.infer_patch_size == self.train_patch_size:
                self.infer_patch_size = tuple(plan.patch_size)
            self.train_patch_size = tuple(plan.patch_size)
        return plan

    # ------------------------------------------------------------------
    def _print_summary(self):
        print("____________________________________________")
        for title, section in (
            ("Training Setup (tr_setup)", self.tr_info),
            ("Training Config (tr_config)", self.tr_configs),
            ("Model Config (model_config)", self.model_config),
            ("Dataset Config (dataset_config)", self.dataset_config),
            ("Inference Config (inference_config)", self.inference_config),
        ):
            print(f"{title}:")
            for k, v in section.items():
                print(f"  {k}: {v}")
            print()
        print("____________________________________________")
