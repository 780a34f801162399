"""Configuration dataclasses.

Flag names mirror the reference argparse blocks
(train_video_Represent.py:209-271, train_video_Compress.py:143-197) so
launch commands port 1:1. One dataclass replaces the two near-identical
argparse blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static per-frame training configuration (hashable for jit)."""

    H: int
    W: int
    num_points: int  # live splats at init
    max_num_points: int  # capacity == args.num_points (see models/represent.py)
    iterations: int
    lr: float = 1e-3
    loss_type: str = "L2"
    lambda_value: float = 0.0
    densification_interval: int = 100
    removal_rate: float = 0.1
    isdensity: bool = False  # --is_ad adaptive control (P-frames)
    isremoval: bool = False  # --is_rm removal control (K-frames)
    block_h: int = 16
    block_w: int = 16
    # early stopping (train_video_Represent.py:83-96)
    early_stop_patience: int = 100
    early_stop_min_delta: float = 1e-9
    stable_control: int = 5000
    # Adan (optimizer.py defaults; the only optimizer GSVC uses)
    betas: Tuple[float, float, float] = (0.98, 0.92, 0.99)
    eps: float = 1e-8
    # rasterizer
    backend: str = "auto"
    max_intersects: Optional[int] = None
    interpret: bool = False  # tile kernel in the Pallas interpreter (tests)

    @property
    def tile_bounds(self) -> Tuple[int, int, int]:
        return (
            (self.W + self.block_w - 1) // self.block_w,
            (self.H + self.block_h - 1) // self.block_h,
            1,
        )


@dataclasses.dataclass
class VideoConfig:
    """Video-level driver configuration (mirrors the argparse flags)."""

    dataset: str
    data_name: str = "video"
    model_name: str = "GaussianVideo"
    model_path: Optional[str] = None
    savdir: str = "result"
    savdir_m: str = "models"
    fps: int = 120
    image_length: int = 50
    width: int = 1920
    height: int = 1080
    iterations: int = 30000
    densification_interval: int = 100
    num_points: int = 10000
    loss_type: str = "L2"
    seed: int = 1
    removal_rate: float = 0.1
    lr: float = 1e-3
    save_imgs: bool = False
    save_everyimgs: bool = False
    is_pos: bool = False
    is_ad: bool = False
    is_rm: bool = False
    checkpoint_dir: str = "./checkpoints"
