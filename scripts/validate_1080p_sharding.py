"""One-shot evidence run: tile-sharded training at the FLAGSHIP
resolution (1920x1080 — 67.5 tile rows, the ragged case) on the virtual
8-device CPU mesh, against the single-device fit.

Run:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/validate_1080p_sharding.py

On four GPUs, `python chip_smoke.py --four` runs the same comparison
through the driver.
"""

import numpy as np

import jax
import jax.numpy as jnp

from gsvc_tpu.config import FrameConfig
from gsvc_tpu.models.represent import fit_frame, init_train_state
from gsvc_tpu.parallel.sharded import fit_frame_sharded, tile_mesh


def main():
    H, W, n = 1080, 1920, 256
    cfg = FrameConfig(
        H=H, W=W, num_points=n, max_num_points=n, iterations=2,
        backend="binned", isremoval=True, densification_interval=2,
    )
    rng = np.random.default_rng(42)
    gt = jnp.asarray(rng.uniform(0, 1, (H, W, 3)), jnp.float32)
    state = init_train_state(jax.random.key(5), cfg)

    ref = fit_frame(state, gt, cfg)
    jax.block_until_ready(ref.state.loss)
    print(f"single-device: loss={float(ref.state.loss):.6f} "
          f"psnr={float(ref.state.psnr):.3f}", flush=True)

    for shards in (2, 4, 8):
        res = fit_frame_sharded(state, gt, cfg, tile_mesh(shards))
        jax.block_until_ready(res.state.loss)
        dl = abs(float(res.state.loss) - float(ref.state.loss))
        dp = max(
            float(jnp.max(jnp.abs(
                getattr(res.state.params, k) - getattr(ref.state.params, k)
            )))
            for k in ("xyz", "cholesky", "features_dc", "rgb_w")
        )
        di = float(jnp.max(jnp.abs(res.image - ref.image)))
        ok = dl < 1e-5 and dp < 2e-3 and di < 5e-3
        print(
            f"--tile_shards {shards} @1080p: |dloss|={dl:.2e} "
            f"max|dparam|={dp:.2e} max|dimage|={di:.2e} "
            f"{'MATCH' if ok else 'MISMATCH'}",
            flush=True,
        )
        assert ok, (shards, dl, dp, di)
    print("1080p ragged tile sharding: ALL SHARD COUNTS MATCH single-device")


if __name__ == "__main__":
    main()
