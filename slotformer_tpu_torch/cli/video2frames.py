"""Videos to frame folders (data preprocessing): the port of
``slotformer_tpu/cli/video2frames.py``.

Every ``.mp4`` under ``--data_root`` becomes a sibling folder of
``{:06d}.jpg`` frames (resized to ``--resize`` square when given: 128 for
Physion), on ``--workers`` threads (OpenCV decodes and PIL encodes outside
the interpreter lock). A video whose folder already holds files is
skipped, so a restarted run continues where it stopped.

Usage:
    python -m slotformer_tpu_torch.cli.video2frames --data_root ./data/CLEVRER/videos
    python -m slotformer_tpu_torch.cli.video2frames --data_root ./data/Physion \
        --resize 128
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor


def convert_one(video_path: str, resize: int = -1) -> int:
    """Write one video's frames; returns how many (0 when its folder was
    already there)."""
    from ..runtime.io import VideoReader, strip_suffix

    frame_dir = strip_suffix(video_path)
    if os.path.isdir(frame_dir) and os.listdir(frame_dir):
        return 0
    with VideoReader(video_path) as reader:
        shape = (resize, resize) if resize > 0 else None
        return reader.cvt2frames(frame_dir, target_shape=shape)


def main(argv=None) -> int:
    """Returns the number of frames written."""
    parser = argparse.ArgumentParser(description="videos -> frame folders")
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--resize", type=int, default=-1)
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)

    videos = []
    for root, _, files in os.walk(args.data_root):
        videos += [os.path.join(root, f) for f in files if f.endswith(".mp4")]
    print(f"[video2frames] {len(videos)} videos under {args.data_root}")
    done = frames = 0
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for n in pool.map(lambda v: convert_one(v, args.resize), videos):
            done += 1
            frames += n
            if done % 100 == 0:
                print(f"  {done}/{len(videos)}", flush=True)
    print(f"[video2frames] done: {frames} frames")
    return frames


if __name__ == "__main__":
    main()
