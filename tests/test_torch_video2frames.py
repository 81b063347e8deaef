"""Port vs JAX: ``cli/video2frames.py`` and ``runtime/io.VideoReader``.

A few-frame mp4 written with OpenCV becomes a folder of ``{:06d}.jpg``
frames through the JAX CLI and through the port's, with and without
``--resize``; the two folders hold the same files and equal arrays (both
decode with OpenCV and encode with PIL). A second run writes nothing.
"""

import os
import shutil

import cv2
import numpy as np

from slotformer_tpu.cli.video2frames import main as jax_video2frames
from slotformer_tpu_torch.cli.video2frames import main as video2frames
from slotformer_tpu_torch.runtime.io import VideoReader, read_img


def _write_mp4(path, frames):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
    for fr in frames:
        writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    writer.release()


def _frames(d):
    names = sorted(os.listdir(d))
    return names, np.stack([read_img(os.path.join(d, n)) for n in names])


def test_video2frames_matches_jax_and_restarts(tmp_path):
    r = np.random.RandomState(0)
    frames = [np.clip(r.randint(0, 256, (48, 64, 3)) // 64 * 64, 0,
                      255).astype(np.uint8) for _ in range(5)]
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    _write_mp4(str(src / "a.mp4"), frames)
    _write_mp4(str(src / "sub" / "b.mp4"), frames[::-1])
    with VideoReader(str(src / "a.mp4")) as reader:
        assert len(reader) == 5 and (reader.height, reader.width) == (48, 64)
        assert reader.get_frame(2).shape == (48, 64, 3)
        assert len(reader.read_video()) == 5
    for resize in (-1, 32):
        roots = {}
        for name, fn in (("jax", jax_video2frames), ("port", video2frames)):
            root = tmp_path / f"{name}{resize}"
            shutil.copytree(src, root)
            fn(["--data_root", str(root), "--resize", str(resize),
                "--workers", "2"])
            roots[name] = root
        for video in ("a", os.path.join("sub", "b")):
            names, got = _frames(roots["port"] / video)
            want_names, want = _frames(roots["jax"] / video)
            assert names == want_names == [f"{i:06d}.jpg" for i in range(5)]
            side = 32 if resize > 0 else None
            assert got.shape == (5, side or 48, side or 64, 3)
            np.testing.assert_array_equal(got, want)
    # a second run skips every folder that holds files
    before = os.path.getmtime(roots["port"] / "a" / "000000.jpg")
    assert video2frames(["--data_root", str(roots["port"])]) == 0
    assert os.path.getmtime(roots["port"] / "a" / "000000.jpg") == before
