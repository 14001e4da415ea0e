"""Worker process for the jax.distributed bootstrap test.

Usage: python _bootstrap_worker.py <coordinator_port> <process_id> <nprocs>

Each process owns 2 virtual CPU devices; together they form a 2x2-device
global mesh. Exercises the pod path end-to-end: bootstrap.initialize ->
global mesh -> sharded engine -> one step -> cross-process readback.
"""

import os
import sys

port, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multi_adapter_particles_tpu.config import SimConfig  # noqa: E402
from multi_adapter_particles_tpu.parallel import (  # noqa: E402
    MeshComputeEngine,
    bootstrap,
    make_mesh,
)

ok = bootstrap.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=nprocs,
    process_id=pid,
)
assert ok, "initialize() must report launched"
assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == 2 * nprocs, len(jax.devices())
assert len(jax.local_devices()) == 2
assert bootstrap.is_primary() == (pid == 0)
assert bootstrap.local_render_device() in jax.local_devices()

mesh = make_mesh()  # global mesh over all processes' devices
assert mesh.devices.size == 2 * nprocs

cfg = SimConfig(num_particles=512, force_model="all_pairs")
eng = MeshComputeEngine(cfg, mesh, seed=0)
eng.simulate()
eng.simulate()
eng.wait_for_gpu()
assert eng.get_fence_value() == 2

# cross-process readback: every process sees the same full trajectory
import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

full = multihost_utils.process_allgather(eng.positions, tiled=True)
assert full.shape == (4, 512), full.shape
assert np.isfinite(full).all()

# single-process reference: the bit-stable schedule must make the pod run
# identical to a local run
from multi_adapter_particles_tpu.models import init as pinit, integrator  # noqa: E402

ref = pinit.initialize_particles_device(512, seed=0)
step = integrator.make_step(cfg, donate=False)
ref = step(step(ref))
np.testing.assert_array_equal(full, np.asarray(ref.position))

# render feed on a pod: gather the global state onto a local device
from multi_adapter_particles_tpu.parallel.sharded import gather_positions  # noqa: E402

local = gather_positions(eng.state, bootstrap.local_render_device())
assert local.shape == (4, 512)
assert local.devices() == {bootstrap.local_render_device()}
np.testing.assert_array_equal(np.asarray(local), full)

# sharded render on the pod: every process rasterizes its local shards;
# only the (C, T) image-pair fold crosses processes (O(pixels) frame
# traffic, not O(N)) and the replicated fold output is readable on
# EVERY host
from multi_adapter_particles_tpu.config import RenderConfig  # noqa: E402
from multi_adapter_particles_tpu.render import camera as rcam  # noqa: E402
from multi_adapter_particles_tpu.render.renderer import Renderer  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from multi_adapter_particles_tpu.parallel import shard_state  # noqa: E402

n_render = 128 * mesh.devices.size  # render_mesh needs 128 lanes/shard
rstate = shard_state(
    pinit.initialize_particles_device(n_render, seed=5), mesh
)
rcfg = RenderConfig(width=128, height=64)
out_m = Renderer(rcfg).render_mesh(
    rstate.position, rcam.Camera(), 6.0, 0.5, mesh
)
frame_m = np.asarray(out_m.frame)  # replicated -> local read, any host
ref_full = np.asarray(
    pinit.initialize_particles_device(n_render, seed=5).position
)
ref_frame = np.asarray(
    Renderer(rcfg).render_arrays(
        jnp.asarray(ref_full), rcam.Camera(), 6.0, 0.5
    ).frame
)
assert frame_m.max() > 0.0, "pod sharded render drew nothing"
np.testing.assert_allclose(frame_m, ref_frame, atol=2e-3)

# distributed-FFT PM on the pod: the slab pipeline's psum_scatter and
# both all_to_all transposes run CROSS-PROCESS here — exactly the
# collectives a real pod would use over DCN/ICI
from multi_adapter_particles_tpu.parallel import (  # noqa: E402
    make_sharded_step, shard_state,
)

cfg_pm = SimConfig(
    num_particles=512, force_model="pm_grid", pm_grid_size=32,
    pm_box=4096.0, interaction_scale=1.0 / 512, pm_distributed_fft=True,
)
sp = shard_state(pinit.initialize_particles_device(512, seed=3), mesh)
out = make_sharded_step(cfg_pm, mesh, donate=False)(sp)
full_pm = multihost_utils.process_allgather(out.position, tiled=True)
ref_pm = integrator.make_step(cfg_pm, donate=False)(
    pinit.initialize_particles_device(512, seed=3)
)
np.testing.assert_allclose(
    full_pm, np.asarray(ref_pm.position), rtol=1e-5, atol=1e-3
)

print(f"BOOTSTRAP_OK pid={pid} devices={len(jax.devices())}", flush=True)
