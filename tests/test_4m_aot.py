"""AOT compile validation of the ACTUAL 4M-shape multi-chip frame
programs (VERDICT r4 #2: "write the multi-chip 4M story down and
validate its program shape").

BASELINE.json places the reference-default N = 4,194,304 on several
devices; these tests pin that the 4M-shape sharded programs LOWER AND
COMPILE on the 8-device virtual mesh — compile-only: AOT lowering
allocates no 4M buffers and nothing executes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_adapter_particles_tpu.config import SimConfig
from multi_adapter_particles_tpu.models.state import ParticleState
from multi_adapter_particles_tpu.parallel import make_mesh, make_sharded_step
from multi_adapter_particles_tpu.parallel.mesh import (
    particle_sharding,
    replicated,
)

N_4M = 4_194_304


def _state_struct(n, mesh):
    sh = particle_sharding(mesh)
    return ParticleState(
        jax.ShapeDtypeStruct((4, n), jnp.float32, sharding=sh),
        jax.ShapeDtypeStruct((3, n), jnp.float32, sharding=sh),
    )


@pytest.mark.slow
def test_4m_sharded_step_compiles(eight_devices):
    """The sharded central-well step (the reference's shipped model at
    its shipped N) over 8 devices: lower + compile, no execution."""
    mesh = make_mesh(eight_devices)
    cfg = SimConfig(num_particles=N_4M, force_model="central_well")
    step = make_sharded_step(cfg, mesh, donate=False)
    compiled = jax.jit(lambda s: step(s)).lower(
        _state_struct(N_4M, mesh)
    ).compile()
    assert compiled is not None


@pytest.mark.slow
def test_4m_shardrender_compiles(eight_devices):
    """-shardrender at 4M/720p: every device rasterizes its 524K-particle
    shard (E = 2.1M sort entries each) and the (C, T) image pairs fold
    over the mesh — the program whose per-shard sort cost the ROADMAP
    scaling model prices. Lower + compile only."""
    from multi_adapter_particles_tpu.render import renderer as rmod

    mesh = make_mesh(eight_devices)
    sh = particle_sharding(mesh)
    rep = replicated(mesh)
    pos = jax.ShapeDtypeStruct((4, N_4M), jnp.float32, sharding=sh)
    f32 = jax.ShapeDtypeStruct((), jnp.float32, sharding=rep)
    wvp = jax.ShapeDtypeStruct((4, 4), jnp.float32, sharding=rep)
    nd = jax.ShapeDtypeStruct((), jnp.int32, sharding=rep)

    lowered = rmod._render_mesh.lower(
        pos, wvp, f32, f32, f32, f32, nd,
        mesh=mesh, width=1280, height=720, seg_q=256,
        dup_y=2, dup_x=2, near=1.0, blend="over",
        composite="xla",
    )
    assert lowered.compile() is not None


def test_4m_struct_shapes_sane(eight_devices):
    """Fast guard (not slow-marked): the 4M state struct shards evenly
    over the 8-device mesh and the lane padding contract holds."""
    mesh = make_mesh(eight_devices)
    st = _state_struct(N_4M, mesh)
    d = int(np.prod(list(mesh.shape.values())))
    assert N_4M % (d * 128) == 0
    assert st.position.shape == (4, N_4M)
