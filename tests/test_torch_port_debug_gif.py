"""The trainer's debug GIF (``train/visualization.py::save_debug_gif``)
written through PIL where imageio is absent, as on the card's machine,
against imageio's file for the same frames: the frame count, every decoded
frame, each frame's duration and the loop count, and the file's bytes
(imageio's GIF plugin is Pillow's)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageSequence

from mt3d_resenc_unet_torch.train import visualization as vis

ROOT = Path(__file__).resolve().parents[1]
TASKS = {"sheet": {"channels": 1}, "normals": {"channels": 3}}


def _panels(depth, size, seed):
    rng = np.random.default_rng(seed)
    inp = rng.random((1, depth, size, size, 1), dtype=np.float32)
    targets = {"sheet": rng.random((1, depth, size, size, 1)),
               "normals": rng.uniform(-1, 1, (1, depth, size, size, 3))}
    outputs = {"sheet": rng.random((1, depth, size, size, 1)),
               "normals": rng.uniform(-1, 1, (1, depth, size, size, 3))}
    return inp, targets, outputs


def _read(path):
    with Image.open(path) as im:
        frames = [(np.asarray(f.convert("RGB")), f.info.get("duration"))
                  for f in ImageSequence.Iterator(im)]
        return frames, im.info.get("loop")


@pytest.mark.parametrize("depth,size,fps", [(6, 12, 8), (9, 16, 5),
                                            (3, 10, 30)])
def test_pil_gif_equals_imageio(tmp_path, monkeypatch, depth, size, fps):
    pytest.importorskip("imageio")
    inp, targets, outputs = _panels(depth, size, seed=depth)
    paths = {}
    for label, has_imageio in (("imageio", True), ("pil", False)):
        monkeypatch.setattr(vis, "_HAS_IMAGEIO", has_imageio)
        paths[label] = vis.save_debug_gif(
            inp, targets, outputs, TASKS, epoch=0,
            save_path=str(tmp_path / f"{label}.gif"), fps=fps)
        assert paths[label] == str(tmp_path / f"{label}.gif")
    (want, want_loop), (got, got_loop) = (_read(paths["imageio"]),
                                          _read(paths["pil"]))
    assert len(got) == len(want) == depth
    assert got_loop == want_loop == 0
    for (a, da), (b, db) in zip(got, want):
        assert a.shape == (2 * size, 3 * size, 3)
        np.testing.assert_array_equal(a, b)
        # GIF stores centiseconds
        assert da == db == int(1000 / fps) // 10 * 10
    assert Path(paths["pil"]).read_bytes() == \
        Path(paths["imageio"]).read_bytes()


def test_gif_written_without_imageio(tmp_path):
    """In a process where ``import imageio`` fails, as on the card's
    machine, the GIF is written and PIL decodes its frames."""
    code = (
        "import sys\n"
        "sys.modules['imageio'] = None\n"
        "sys.modules['imageio.v2'] = None\n"
        "import numpy as np\n"
        "from mt3d_resenc_unet_torch.train import visualization as vis\n"
        "assert not vis._HAS_IMAGEIO\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.random((5, 8, 8, 1))\n"
        "t = {'sheet': {'channels': 1}}\n"
        "print(vis.save_debug_gif(x, {'sheet': x}, {'sheet': x}, t, 0,\n"
        "                         sys.argv[1]))\n")
    out = tmp_path / "m_debug.gif"
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == str(out)
    frames, loop = _read(out)
    assert len(frames) == 5 and loop == 0
    assert all(d == 120 for _, d in frames)     # 125 ms in centiseconds
