"""Monitor: per-episode video + episode-stats recording wrapper.

Port of the JAX package's ``monitor.py``. The reference demo optionally
wraps the env in ``gym.wrappers.Monitor`` (mcr:714-717), which writes one
video file per episode plus JSON stats (episode rewards, lengths,
timestamps). This is the equivalent for the facade:

    env = monitor.Monitor(multi_car_racing_tpu_torch.make("MultiCarRacing-v0"), "/tmp/run1")
    env.reset(); env.step(a); ...; env.close()

- one ``episode{k:06d}.mp4`` per episode (agent views tiled horizontally,
  the 600x400 rgb_array viewport each, 50 fps like the reference's
  registration), through OpenCV; a GIF through Pillow when OpenCV is
  missing or writes nothing; with neither installed, recording a video
  raises ``RuntimeError`` (pass ``video_callable=lambda i: False`` to keep
  the stats only),
- ``stats.json`` with per-episode returns (per agent), lengths, file names
  and wall-clock timestamps, written on ``close()`` and kept current after
  every episode (crash-safe: atomic replace).

``video_callable`` mirrors the gym Monitor knob: a predicate on the episode
index (default: record every episode). An output directory that already
holds Monitor files is refused unless ``force=True``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import config as C


def encoders() -> list[str]:
    """The video encoders this Python has: "mp4" (OpenCV), "gif" (Pillow)."""
    import importlib.util

    return [name for name, mod in (("mp4", "cv2"), ("gif", "PIL"))
            if importlib.util.find_spec(mod) is not None]


def _write_video(path: str, frames, fps: int) -> str:
    """Write frames (list of (H, W, 3) uint8) to mp4; GIF fallback.

    Returns the path actually written."""
    have = encoders()
    if not have:
        raise RuntimeError("Monitor: no video encoder (neither OpenCV nor Pillow is "
                           "installed); pass video_callable=lambda i: False to record "
                           "stats only")
    if "mp4" in have:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in frames:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return path
        if "gif" not in have:
            raise RuntimeError(f"Monitor: OpenCV wrote no video to {path}, and Pillow is "
                               "not installed for the GIF fallback")
    gif = os.path.splitext(path)[0] + ".gif"
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                 duration=max(1, int(1000 / fps)), loop=0)
    return gif


class Monitor:
    """Record episodes of a facade env (``make()`` result or raw
    ``MultiCarRacing``) to ``directory``."""

    def __init__(self, env, directory: str, video_callable=None,
                 fps: int = C.FPS, force: bool = False):
        self.env = env
        self.directory = directory
        self.video_callable = video_callable or (lambda episode_id: True)
        self.fps = fps
        os.makedirs(directory, exist_ok=True)
        existing = [f for f in os.listdir(directory)
                    if f.startswith("episode") or f == "stats.json"]
        if existing and not force:
            raise RuntimeError(
                f"{directory} already contains Monitor output "
                f"({existing[:3]}...); pass force=True to append"
            )
        self.episode_id = 0
        self.stats = dict(episode_returns=[], episode_lengths=[],
                          episode_files=[], timestamps=[])
        self._frames = []
        self._ep_return = None
        self._ep_len = 0
        self._recording = False

    def __getattr__(self, name):
        if name == "env" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.env, name)

    def _capture(self):
        if not self._recording:
            return
        frames = self.env.render("rgb_array")  # (N, H, W, 3)
        self._frames.append(
            np.concatenate(list(np.asarray(frames)), axis=1)
        )

    def reset(self):
        if self._ep_len:
            self._finish_episode()
        obs = self.env.reset()
        self._recording = bool(self.video_callable(self.episode_id))
        self._frames = []
        self._ep_return = None
        self._ep_len = 0
        self._capture()
        return obs

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        r = np.asarray(r, np.float64)
        self._ep_return = r if self._ep_return is None else self._ep_return + r
        self._ep_len += 1
        self._capture()
        if done:
            self._finish_episode()
        return obs, r, done, info

    def _finish_episode(self):
        if self._ep_len == 0:
            return
        fname = None
        if self._frames:
            fname = os.path.join(
                self.directory, f"episode{self.episode_id:06d}.mp4"
            )
            fname = _write_video(fname, self._frames, self.fps)
        self.stats["episode_returns"].append(
            np.asarray(self._ep_return).tolist()
        )
        self.stats["episode_lengths"].append(self._ep_len)
        self.stats["episode_files"].append(
            os.path.basename(fname) if fname else None
        )
        self.stats["timestamps"].append(time.time())
        self.episode_id += 1
        self._frames = []
        self._ep_return = None
        self._ep_len = 0
        self._recording = False
        self._write_stats()

    def _write_stats(self):
        tmp = os.path.join(self.directory, ".stats.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.stats, f, indent=1)
        os.replace(tmp, os.path.join(self.directory, "stats.json"))

    def close(self):
        self._finish_episode()
        self._write_stats()
        self.env.close()
