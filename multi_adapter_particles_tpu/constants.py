"""Framework-wide physical and sizing constants.

Mirrors the reference's compile-time configuration so behavior is reproducible:
- `Particles/defines.h:34-45` (block size, speed/size/intensity/spread, count range)
- `Particles/nBodyGravityCS.hlsl:37-38` (mass, softening^2)
- `Particles/Compute.cpp:543-546` (dt, damping pushed into the CS constant buffer)
- `Particles/Render.cpp:139,776` (camera position, fov, near/far)
- `Particles/Main-Particles.cpp:50` (default window 1024x1024)
"""

# --- simulation kernel sizing (defines.h:37) -------------------------------
# The reference dispatches 64-wide thread groups. BLOCK_SIZE survives as the
# granularity of the decoupled num_sim knob so parity configs are
# expressible.
BLOCK_SIZE = 64

# Particle counts are padded to a multiple of this, so the trailing array
# dimension splits into whole 128-wide blocks (kernel blocks, render
# chunks, mesh shards).
LANE = 128

# --- initial conditions (defines.h:39-42, Compute.cpp:832-844) -------------
INITIAL_PARTICLE_SPEED = 15.0
INITIAL_PARTICLE_SIZE = 2.5
INITIAL_PARTICLE_INTENSITY = 0.15
PARTICLE_SPREAD = 400.0
# Two clusters centered at +/- (PARTICLE_SPREAD * 0.75, 0, 0)  (Compute.cpp:832)
CLUSTER_CENTER_X = PARTICLE_SPREAD * 0.75
# Rejection-accumulation loop threshold on |delta|^2  (Compute.cpp:690-695)
INIT_DELTA_LENGTH_SQ_MIN = 10.0

# --- particle count range (defines.h:44-45) --------------------------------
MIN_NUM_PARTICLES = 256 * 1024
MAX_NUM_PARTICLES = 4 * 1024 * 1024
DEFAULT_NUM_PARTICLES = MAX_NUM_PARTICLES

# --- physics (nBodyGravityCS.hlsl:37-38, Compute.cpp:545-546) ---------------
PARTICLE_MASS = 70000.0
SOFTENING_SQUARED = 25.0
TIMESTEP = 0.1
DAMPING = 1.0
# VS colormap divisor for |accel| stored in pos.w  (ParticleDraw.hlsl:106)
ACCEL_COLOR_SCALE = 9.0

# --- camera / display (Render.cpp:139,776; Main-Particles.cpp:50) ----------
CAMERA_POSITION = (0.0, 0.0, 1500.0)
CAMERA_FOV_Y = 0.8          # radians
CAMERA_NEAR = 1.0
CAMERA_FAR = 5000.0
DEFAULT_WINDOW_WIDTH = 1024
DEFAULT_WINDOW_HEIGHT = 1024

# Point-sprite base colors (ParticleDraw.hlsl:104-109): lerp from hot red to
# the per-vertex color (all particles get (1, 1, 0.2, 1), Render.cpp:695-699).
SPRITE_COLOR_COLD = (1.0, 0.1, 0.1, 1.0)
SPRITE_COLOR_HOT = (1.0, 1.0, 0.2, 1.0)
# id-hash blue channel mask (ParticleDraw.hlsl:108)
SPRITE_ID_MASK = 0xFFF
