"""The benchmark's plain reference: a frozen copy, in plain PyTorch and
NumPy, of the arithmetic the program's frames are judged against.

It imports nothing of the program and takes nothing the program made:
it builds its own scenes from the configuration and the seed, its own sky
table, its own rays, and decodes the bytes the program wrote. Every
function takes the working ``dtype``, so the same code computes the
float32 reference and the control (the reference in bfloat16).

- ``vec``: 3-vector math, the correctly rounded square root, the emulated
  fused multiply-add;
- ``camera``: the orbit camera;
- ``sky``: the cubemap's nearest-texel gather; ``sky_<name>``: a sky's
  texels and lookups, found by the configuration's ``sky`` (``colors``);
- ``demo`` and ``many``: the two scene kinds, each with its own trace
  (the linear object scan; the dense sphere and triangle tester);
- ``raytrace``: the eager integrator (ray generation, the masked bounce
  loop, the lighting, the sample average, the u8 quantization);
- ``pathtrace``: the path tracer's plain version, its counter-based
  random stream included;
- ``ansi``: the decoder of the ANSI truecolor frames the program writes.
"""
