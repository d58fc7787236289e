"""The port's data-prep tools and importers against the JAX package's, on
the CPU, on the same inputs: values equal (the port writes ``compressor:
null`` stores where the JAX tools write Blosc, and images through cv2
where they use imageio).

* ``zarr_crop``, ``tiff_to_zarr`` (segment folders and generic stacks),
  ``normals_slices``, ``mesh_rasterize`` (OBJ loading, the normals slice,
  the normals and label image exports);
* ``import_torch``: the reference ``.pth`` names into the port's state
  dict, equal to the JAX importer's tree through ``params_from_jax``, a
  strict load into the port's model, and the transposed-conv flip against
  ``torch.nn.functional.conv_transpose3d``;
* ``from_jax.state_from_jax``: a JAX AdamW run of 2 updates resumes in the
  port's ``Trainer`` state machinery for 2 more, within OPT_TOL of the
  JAX move; SGD's trace likewise; through the README's ``np.savez`` file.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mt3d_resenc_unet_tpu.data import zio as jzio
from mt3d_resenc_unet_torch.data import zio as tzio
from mt3d_resenc_unet_torch.tools.images import read_image

cv2 = pytest.importorskip("cv2")

OPT_TOL = 1e-4
# (lr0, epochs, steps an epoch): the 3rd and 4th updates start epoch 1
SCHEDULE = (1e-2, 10, 3)


def _meta(path):
    with open(os.path.join(path, ".zarray")) as f:
        return json.load(f)


def _same_store(port_path, jax_path):
    got = tzio.open_zarr(port_path).read_all()
    want = jzio.open_zarr(jax_path).read_all()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert _meta(port_path)["compressor"] is None


def test_zarr_crop_matches_jax(tmp_path):
    from mt3d_resenc_unet_tpu.tools.zarr_crop import cut_zarr_bounding_box as j
    from mt3d_resenc_unet_torch.tools.zarr_crop import (
        cut_zarr_bounding_box as t)
    data = np.arange(40 * 40 * 40, dtype=np.uint16).reshape(40, 40, 40)
    src = str(tmp_path / "src.zarr")
    tzio.create_zarr(src, data.shape, data.dtype, (16, 16, 16),
                     compressor=None)[...] = data
    box = (5, 30, 10, 35, 0, 20)
    _same_store(t(src, str(tmp_path / "port.zarr"), *box),
                j(src, str(tmp_path / "jax.zarr"), *box))
    np.testing.assert_array_equal(
        tzio.open_zarr(str(tmp_path / "port.zarr")).read_all(),
        data[5:30, 10:35, 0:20])


def _segment(root):
    seg = root / "seg01"
    (seg / "layers").mkdir(parents=True)
    (seg / "inklabels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        cv2.imwrite(str(seg / "layers" / f"layer_{i:02d}.png"),
                    rng.integers(0, 65535, (20, 24), np.uint16))
        ink = np.zeros((20, 24), np.uint8)
        ink[4:16, 3:20] = 255 * (rng.random((12, 17)) > 0.2)
        cv2.imwrite(str(seg / "inklabels" / f"ink_{i:02d}.png"), ink)
    return seg


@pytest.mark.parametrize("erode", [False, True])
def test_stack_images_to_zarr_matches_jax(tmp_path, erode):
    from mt3d_resenc_unet_tpu.tools.tiff_to_zarr import stack_images_to_zarr as j
    from mt3d_resenc_unet_torch.tools.tiff_to_zarr import (
        stack_images_to_zarr as t)
    seg_j = _segment(tmp_path / "jax")
    seg_t = _segment(tmp_path / "port")
    kw = dict(start=0, stop=4, erode=erode, chunks=(4, 16, 16),
              num_threads=4)
    gj, gt = j(str(seg_j), **kw), t(str(seg_t), **kw)
    for name in ("layers.zarr", "inklabels.zarr"):
        _same_store(os.path.join(gt, name), os.path.join(gj, name))


def test_slices_to_zarr_matches_jax(tmp_path):
    from mt3d_resenc_unet_tpu.tools.tiff_to_zarr import slices_to_zarr as j
    from mt3d_resenc_unet_torch.tools.tiff_to_zarr import slices_to_zarr as t
    d = tmp_path / "stack"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        cv2.imwrite(str(d / f"{i:03d}.png"),
                    rng.integers(0, 65535, (16, 20, 3), np.uint16))
    kw = dict(pattern="*.png", chunks=(4, 8, 8, 3), num_threads=3)
    _same_store(t(str(d), str(tmp_path / "port.zarr"), **kw),
                j(str(d), str(tmp_path / "jax.zarr"), **kw))


@pytest.mark.parametrize("use_16bit", [True, False])
def test_normals_slices_match_jax(tmp_path, use_16bit):
    from mt3d_resenc_unet_tpu.tools.normals_slices import (
        write_normals_slices as j)
    from mt3d_resenc_unet_torch.tools.normals_slices import (
        write_normals_slices as t)
    rng = np.random.default_rng(2)
    vol = np.full((3, 4, 8, 8), 40000, np.uint16)
    if use_16bit:
        vol = rng.integers(0, 65535, vol.shape, np.uint16)
    path = str(tmp_path / "n.zarr")
    tzio.create_zarr(path, vol.shape, vol.dtype, vol.shape,
                     compressor=None)[...] = vol
    assert t(path, str(tmp_path / "port"), use_16bit) == \
        j(path, str(tmp_path / "jax"), use_16bit) == 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        np.testing.assert_array_equal(read_image(str(tmp_path / "port" / name)),
                                      read_image(str(tmp_path / "jax" / name)))


def _write_obj(path, z0, tilt=0.0, size=12.0):
    """A square at height z0 (tilted along x by ``tilt``), normals given."""
    with open(path, "w") as f:
        for x, y in [(1, 1), (size, 1), (size, size), (1, size)]:
            f.write(f"v {x} {y} {z0 + tilt * x}\n")
        n = np.array([-tilt, 0.0, 1.0]) / np.hypot(tilt, 1.0)
        for _ in range(4):
            f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        f.write("f 1//1 2//2 3//3\nf 1//1 3//3 4//4\n")


def test_mesh_obj_and_normals_slice_match_jax(tmp_path):
    from mt3d_resenc_unet_tpu.tools import mesh_rasterize as j
    from mt3d_resenc_unet_torch.tools import mesh_rasterize as t
    p = str(tmp_path / "m.obj")
    _write_obj(p, 3.0, tilt=0.4)
    vj, tj, nj = j.load_obj(p)
    vt, tt, nt = t.load_obj(p)
    for a, b in ((vt, vj), (tt, tj), (nt, nj)):
        np.testing.assert_array_equal(a, b)
    for z in (3.0, 5.0, 7.5):
        got = t.rasterize_normals_slice(vt, tt, nt, z, 16, 16)
        want = j.rasterize_normals_slice(vj, tj, nj, z, 16, 16)
        np.testing.assert_array_equal(got, want)
    assert t.rasterize_normals_slice(vt, tt, nt, 5.0, 16, 16).any()


def test_mesh_exports_match_jax(tmp_path):
    from mt3d_resenc_unet_tpu.tools import mesh_rasterize as j
    from mt3d_resenc_unet_torch.tools import mesh_rasterize as t
    paths = [str(tmp_path / "a.obj"), str(tmp_path / "b.obj")]
    _write_obj(paths[0], 2.0)
    _write_obj(paths[1], 5.0, tilt=0.2)
    t.write_mesh_labels(paths, str(tmp_path / "port_l"), (0, 8), 16, 16,
                        num_threads=2)
    j.write_mesh_labels(paths, str(tmp_path / "jax_l"), (0, 8), 16, 16,
                        num_threads=2)
    for z in range(8):
        name = f"{z:05d}.png"
        np.testing.assert_array_equal(
            read_image(str(tmp_path / "port_l" / name)),
            read_image(str(tmp_path / "jax_l" / name)))
    assert (read_image(str(tmp_path / "port_l" / "00002.png")) == 1).any()
    # the normals export: the JAX tool's own slices, as 16-bit RGB PNGs
    t.write_face_normals(paths, str(tmp_path / "port_n"), (0, 8), 16, 16,
                         num_threads=2)
    meshes = [j.load_obj(p) for p in paths]
    for z in range(8):
        want = np.zeros((16, 16, 3), np.uint16)
        for v, tri, vn in meshes:
            sl = j.rasterize_normals_slice(v, tri, vn, float(z), 16, 16)
            want[sl.any(axis=-1)] = sl[sl.any(axis=-1)]
        got = read_image(str(tmp_path / "port_n" / f"{z:05d}.png"))
        np.testing.assert_array_equal(got, want)
        assert os.path.exists(tmp_path / "port_n" / f"{z:05d}_viz.jpg")


# ----------------------------------------------------------------------
# importers
# ----------------------------------------------------------------------

MODEL = dict(basic_encoder_block="BasicBlockD", basic_decoder_block="ConvBlock",
             bottleneck_block="BasicBlockD", features_per_stage=[8, 16],
             num_stages=2, n_blocks_per_stage=[1, 1],
             n_conv_per_stage_decoder=[1], kernel_sizes=[3, 3],
             strides=[1, 2])


def _reference_state_dict():
    """The reference's names (tests/test_import_torch.py's state dict)."""
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    return {
        "shared_encoder.stem.convs.0.conv.weight": t(8, 1, 3, 3, 3),
        "shared_encoder.stages.0.blocks.0.conv1.conv.weight": t(8, 8, 3, 3, 3),
        "shared_encoder.stages.0.blocks.0.conv2.conv.weight": t(8, 8, 3, 3, 3),
        "shared_encoder.stages.1.blocks.0.conv1.conv.weight": t(16, 8, 3, 3,
                                                                 3),
        "shared_encoder.stages.1.blocks.0.conv2.conv.weight": t(16, 16, 3, 3,
                                                                 3),
        "shared_encoder.stages.1.blocks.0.skip.1.conv.weight": t(16, 8, 1, 1,
                                                                  1),
        "task_decoders.sheet.transpconvs.0.weight": t(16, 8, 2, 2, 2),
        "task_decoders.sheet.stages.0.convs.0.conv.weight": t(8, 16, 3, 3,
                                                               3),
        "task_decoders.sheet.seg_layers.0.weight": t(1, 8, 1, 1, 1),
        "task_decoders.sheet.seg_layers.0.bias": t(1),
    }


def test_import_torch_matches_jax_and_loads_strictly(tmp_path):
    from mt3d_resenc_unet_tpu.tools.import_torch import (
        convert_state_dict as jconvert)
    from mt3d_resenc_unet_torch.core.plan import (TaskHead,
                                                  plan_from_manual_config)
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
    from mt3d_resenc_unet_torch.tools.import_torch import import_checkpoint
    from mt3d_resenc_unet_torch.train.checkpoint import load_params_any
    sd = _reference_state_dict()
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": sd}, pth)
    got = import_checkpoint(pth, str(tmp_path / "params.pt"))
    want = params_from_jax(jconvert(sd))
    assert set(got) == set(want) and len(got) == len(sd)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    saved = load_params_any(str(tmp_path / "params.pt"))
    assert all(torch.equal(saved[k], got[k]) for k in got)
    plan = plan_from_manual_config(MODEL, (8, 8, 8), 1,
                                   [TaskHead("sheet", 1, "sigmoid")])
    model = ResEncUNet(plan)
    fresh = model.state_dict()
    missing = set(fresh) - set(got)
    assert all(k.endswith("bias") for k in missing), missing
    model.load_state_dict({**fresh, **got})
    assert model(torch.zeros(1, 8, 8, 8, 1))["sheet"].shape == (1, 8, 8, 8, 1)


def test_import_torch_flips_the_transposed_conv():
    """An imported ConvTranspose3d weight through the port's
    ``UpsampleConv`` gives torch's conv_transpose3d (the importer flips the
    spatial axes, the module flips them back as flax does)."""
    from mt3d_resenc_unet_torch.models.network import UpsampleConv
    from mt3d_resenc_unet_torch.tools.import_torch import _transp_kernel
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, 3, 4, 5)).astype(np.float32)   # NCDHW
    w = rng.standard_normal((6, 4, 2, 2, 2)).astype(np.float32)   # (I,O,*k)
    ref = F.conv_transpose3d(torch.from_numpy(x), torch.from_numpy(w),
                             stride=2)
    x_cl = torch.from_numpy(np.transpose(x, (0, 2, 3, 4, 1)).copy())
    up = UpsampleConv(6, 4, (2, 2, 2))
    with torch.no_grad():
        up.kernel.copy_(torch.from_numpy(_transp_kernel(w).copy()))
        out = up(x_cl)
    torch.testing.assert_close(out.permute(0, 4, 1, 2, 3), ref,
                               rtol=1e-5, atol=1e-5)


def _adam_run(n_before=2, n_after=2, optimizer="AdamW"):
    """A JAX run of ``n_before`` updates, its state, and the parameters
    after ``n_after`` more, on fixed numpy gradients."""
    from mt3d_resenc_unet_tpu.train import step as js
    rng = np.random.default_rng(5)
    params = {"enc": {"kernel": rng.standard_normal((3, 3, 3, 2, 4)).astype(
        np.float32), "bias": rng.standard_normal(4).astype(np.float32)},
        "seg": {"kernel": rng.standard_normal((2, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 0.1, params) for _ in range(n_before + n_after)]
    tx = js.build_optimizer(optimizer, js.cosine_epoch_schedule(*SCHEDULE),
                            weight_decay=1e-2)
    opt_state = tx.init(params)
    p = jax.tree.map(jnp.asarray, params)
    update = jax.jit(tx.update)
    for g in grads[:n_before]:
        u, opt_state = update(g, opt_state, p)
        p = jax.tree.map(jnp.add, p, u)
    mid = (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, opt_state))
    for g in grads[n_before:]:
        u, opt_state = update(g, opt_state, p)
        p = jax.tree.map(jnp.add, p, u)
    return mid, jax.tree.map(np.asarray, p), grads[n_before:]


class _Net(torch.nn.Module):
    """The JAX tree's names as a torch module (``enc.kernel``, ...)."""

    def __init__(self, sd):
        super().__init__()
        self.enc = torch.nn.Module()
        self.seg = torch.nn.Module()
        for name, value in sd.items():
            mod, leaf = name.split(".")
            setattr(getattr(self, mod), leaf,
                    torch.nn.Parameter(torch.zeros_like(value)))


def _resume(state, grads, optimizer):
    from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule)
    from mt3d_resenc_unet_torch.train.trainer import Trainer
    net = _Net(state["params"])
    opt = build_optimizer(net.parameters(), optimizer,
                          cosine_epoch_schedule(*SCHEDULE), weight_decay=1e-2)
    Trainer._load_state(state, net, opt)
    assert opt.count == 2
    for g in grads:
        flat = params_from_jax(g)
        for name, p in net.named_parameters():
            p.grad = flat[name].clone()
        opt.step()
    return {n: p.detach() for n, p in net.named_parameters()}


@pytest.mark.parametrize("optimizer", ["AdamW", "SGD"])
def test_state_from_jax_resumes_the_jax_run(optimizer):
    from mt3d_resenc_unet_torch.tools.from_jax import (params_from_jax,
                                                       state_from_jax)
    (p_mid, s_mid), p_end, grads = _adam_run(optimizer=optimizer)
    state = state_from_jax(p_mid, s_mid, 2, optimizer)
    got = _resume(state, grads, optimizer)
    mid, end = params_from_jax(p_mid), params_from_jax(p_end)
    for name, want in end.items():
        move = (want - mid[name]).abs().max()
        err = (got[name] - want).abs().max()
        assert err <= OPT_TOL * move, (name, float(err), float(move))


def test_state_from_jax_through_the_readme_npz(tmp_path):
    """The README's JAX side (flatten the state's paths with "/", then
    ``np.savez``) and the port's side (``unflatten``, ``state_from_jax``)."""
    from mt3d_resenc_unet_torch.tools.from_jax import (params_from_jax,
                                                       state_from_jax,
                                                       unflatten)
    (p_mid, s_mid), p_end, grads = _adam_run()
    tree = {"params": p_mid, "opt_state": s_mid, "step": np.int32(2)}
    flat = {"/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(tmp_path / "state.npz", **flat)
    with np.load(tmp_path / "state.npz") as f:
        back = unflatten(dict(f))
    state = state_from_jax(back["params"], back["opt_state"],
                           int(back["step"]), "AdamW")
    got = _resume(state, grads, "AdamW")
    for name, want in params_from_jax(p_end).items():
        move = (want - params_from_jax(p_mid)[name]).abs().max()
        assert (got[name] - want).abs().max() <= OPT_TOL * move, name


def test_state_from_jax_refuses_what_it_cannot_carry():
    from mt3d_resenc_unet_torch.tools.from_jax import state_from_jax
    with pytest.raises(NotImplementedError, match="lamb"):
        state_from_jax({"a": np.zeros(2)}, (), 0, "lamb")
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        state_from_jax({"a": np.zeros(2)}, ({"trace": {}},), 0, "AdamW")
