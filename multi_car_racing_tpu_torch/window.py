"""Interactive pixel window(s) for ``render('human')``.

A copy of the JAX package's ``window.py`` (numpy and pygame; the port
imports nothing of that package). The reference opens one 1000x800 pyglet
window PER AGENT, captioned "Car {id}", and flips the GL framebuffer every
render call, returning each window's ``isopen`` (mcr:529-536, 595-597); the
demo loop gates on ``env.render().all()`` (mcr:735).

Windowing is best-effort, in order:

1. **Per-agent OS windows** via pygame's SDL2 window API
   (``pygame._sdl2.video.Window``): one window per agent, the reference's
   captions, per-window close tracking, as the reference does.
2. If the SDL2 window API is unavailable, ONE classic pygame window tiling
   the agent views side by side (a documented divergence).
3. Headless (no ``$DISPLAY`` / ``$WAYLAND_DISPLAY``), the facade returns
   the frames themselves instead. ``MCR_FORCE_WINDOW=1`` forces SDL's
   default video back end (``SDL_VIDEODRIVER=dummy`` exercises the window path in
   tests).
"""

from __future__ import annotations

import os

import numpy as np


def display_available() -> bool:
    return bool(
        os.environ.get("DISPLAY")
        or os.environ.get("WAYLAND_DISPLAY")
        or os.environ.get("MCR_FORCE_WINDOW")
    )


class _AgentWindow:
    """One SDL2 window + renderer + streaming texture for one agent."""

    def __init__(self, pygame, idx: int, w: int, h: int):
        from pygame._sdl2 import video

        self._video = video
        self.window = video.Window(f"Car {idx}", size=(w, h))
        self.renderer = video.Renderer(self.window)
        self.isopen = True
        self._size = (w, h)
        self._win_id = self.window.id

    def show(self, pygame, frame: np.ndarray):
        if not self.isopen:
            return False
        surf = pygame.surfarray.make_surface(frame.swapaxes(0, 1))
        tex = self._video.Texture.from_surface(self.renderer, surf)
        self.renderer.clear()
        tex.draw(dstrect=(0, 0, *self._size))
        self.renderer.present()
        return True

    def close(self):
        if self.isopen:
            try:
                self.window.destroy()
            except Exception:  # pragma: no cover - display-dependent
                pass
            self.isopen = False


class HumanViewer:
    """Per-agent SDL2 windows (reference behavior); single-window tiling
    fallback. ``show`` returns per-agent isopen bools."""

    def __init__(self, caption: str = "MultiCarRacing"):
        self._caption = caption
        self._pygame = None
        self._windows = None      # list[_AgentWindow] | None
        self._screen = None       # single-window fallback surface
        self.isopen = True

    def _ensure(self, frames):
        import pygame

        if self._pygame is None:
            pygame.init()
            self._pygame = pygame
            n, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
            try:
                self._windows = [
                    _AgentWindow(pygame, i, w, h) for i in range(n)
                ]
            except Exception:  # pragma: no cover - SDL2 API unavailable
                self._windows = None
                pygame.display.set_caption(self._caption)
                self._screen = pygame.display.set_mode((n * w, h))
        return self._pygame

    def show(self, frames) -> np.ndarray:
        """frames: (N, H, W, 3) uint8. Returns (N,) isopen bools."""
        frames = np.asarray(frames)
        n = frames.shape[0]
        if not self.isopen:
            return np.zeros((n,), dtype=bool)
        try:
            pygame = self._ensure(frames)
            if self._windows is not None:
                for ev in pygame.event.get():
                    if ev.type == pygame.QUIT:
                        self.close()
                    elif ev.type == pygame.WINDOWCLOSE:
                        wid = getattr(ev, "window", None)
                        wid = getattr(wid, "id", None)
                        for aw in self._windows:
                            if wid is None or aw._win_id == wid:
                                aw.close()
                open_flags = np.array(
                    [aw.show(pygame, frames[i])
                     for i, aw in enumerate(self._windows)]
                )
                if not open_flags.any():
                    self.close()
                return open_flags
            # single-window tiling fallback
            tiled = np.concatenate(list(frames), axis=1)  # (H, N*W, 3)
            surf = pygame.surfarray.make_surface(tiled.swapaxes(0, 1))
            self._screen.blit(surf, (0, 0))
            pygame.display.flip()
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    self.close()
        except Exception:  # pragma: no cover - display-dependent
            self.close()
        return np.full((n,), self.isopen, dtype=bool)

    def close(self):
        if self._windows is not None:
            for aw in self._windows:
                aw.close()
            self._windows = None
        if self._pygame is not None:
            try:
                self._pygame.display.quit()
                self._pygame.quit()
            except Exception:  # pragma: no cover
                pass
            self._pygame = None
            self._screen = None
        self.isopen = False
