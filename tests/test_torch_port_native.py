"""The port's host ops (``utils/native.py`` over ``native/hostops.cpp``): each
C++ function against its ``*_plain`` numpy version, bit for bit (same
float32 operations in the same order), the build under ``build/hostops/``
(never the JAX loader's ``native/libhostops.so``), and the refusals: a
failed build raises with the compiler's output, a wrong array raises."""

import numpy as np
import pytest

from mt3d_resenc_unet_torch.utils import native

SHAPES = [(1, 9, 10, 11), (3, 20, 30, 40), (3, 4, 5, 600)]


def _counts(rng, shape):
    cnt = rng.random(shape).astype(np.float32) * 2
    cnt[cnt < 0.3] = 0.0          # uncovered voxels stay untouched
    return cnt


@pytest.mark.parametrize("shape", SHAPES)
def test_accumulate_patch_matches_plain(shape):
    rng = np.random.default_rng(1)
    c, sz, sy, sx = shape
    pz, py, px = sz // 2 + 1, sy // 2 + 1, sx // 2 + 1
    sums = rng.standard_normal(shape).astype(np.float32)
    cnt = rng.random(shape[1:]).astype(np.float32)
    pred = rng.standard_normal((c, pz, py, px)).astype(np.float32)
    wmap = rng.random((pz, py, px)).astype(np.float32)
    got_s, got_c = sums.copy(), cnt.copy()
    native.accumulate_patch(got_s, got_c, pred, wmap, 1, sy - py, 2)
    native.accumulate_patch_plain(sums, cnt, pred, wmap, 1, sy - py, 2)
    np.testing.assert_array_equal(got_s, sums)
    np.testing.assert_array_equal(got_c, cnt)


@pytest.mark.parametrize("shape", SHAPES)
def test_finalize_average_matches_plain(shape):
    rng = np.random.default_rng(2)
    sums = rng.standard_normal(shape).astype(np.float32) * 5
    cnt = _counts(rng, shape[1:])
    got = sums.copy()
    native.finalize_average(got, cnt)
    native.finalize_average_plain(sums, cnt)
    np.testing.assert_array_equal(got, sums)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[0] == 3])
def test_renormalize_vectors_matches_plain(shape):
    rng = np.random.default_rng(3)
    sums = rng.standard_normal(shape).astype(np.float32) * 7
    sums[:, 0, 0, :4] = 0.0       # zero vectors keep their (zero) value
    sums[:, 0, 1, :4] = 1e-32     # below the 1e-30 magnitude floor
    cnt = _counts(rng, shape[1:])
    cnt[0, :2, :4] = 1.0
    orig = sums.copy()
    got = sums.copy()
    native.renormalize_vectors(got, cnt)
    native.renormalize_vectors_plain(sums, cnt)
    np.testing.assert_array_equal(got, sums)
    covered = cnt > 0
    mag = np.linalg.norm(got, axis=0)
    np.testing.assert_allclose(mag[covered & (np.linalg.norm(orig, axis=0)
                                              > 1e-20)], 1.0, atol=1e-6)
    np.testing.assert_array_equal(got[:, ~covered], orig[:, ~covered])


@pytest.mark.parametrize("fn", ["quantize_u8", "encode_normals_u16"])
def test_quantize_matches_plain(fn):
    rng = np.random.default_rng(4)
    block = rng.uniform(-1.3, 1.3, (3, 17, 19, 23)).astype(np.float32)
    # exact code boundaries and the clip limits
    block.flat[:6] = [0.0, 1.0, -1.0, 127 / 255, 0.5, 2.0]
    got = getattr(native, fn)(block)
    want = getattr(native, f"{fn}_plain")(block)
    assert got.dtype == want.dtype == (np.uint8 if fn == "quantize_u8"
                                       else np.uint16)
    np.testing.assert_array_equal(got, want)


def test_library_builds_under_build_not_native():
    native.load()
    target = native._target()
    assert target.exists()
    assert target.parent == native.BUILD_DIR
    assert target.parent.parent.name == "build"
    assert target.name != "libhostops.so"


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "hostops.cpp"
    bad.write_text("extern \"C\" int hostops_abi_version() { return }\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.quantize_u8(np.zeros(4, np.float32))
    assert not list((tmp_path / "out").glob("*.so"))


@pytest.mark.parametrize("case", ["dtype", "strided", "shape", "bounds"])
def test_wrappers_refuse_wrong_arrays(case):
    sums = np.zeros((1, 4, 4, 4), np.float32)
    cnt = np.zeros((4, 4, 4), np.float32)
    pred = np.ones((1, 2, 2, 2), np.float32)
    wmap = np.ones((2, 2, 2), np.float32)
    with pytest.raises(ValueError):
        if case == "dtype":
            native.finalize_average(sums.astype(np.float64), cnt)
        elif case == "strided":
            native.quantize_u8(sums[..., ::2])
        elif case == "shape":
            native.renormalize_vectors(sums, cnt)
        else:
            native.accumulate_patch(sums, cnt, pred, wmap, 3, 0, 0)
