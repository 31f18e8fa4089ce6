"""hesic_tpu_torch: the PyTorch/CUDA port of hesic_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (codecs/, layers/, entropy_models/,
geometry/, models/, utils/) so each module's counterpart is found by name.
It imports torch and numpy only: nothing of JAX and nothing of hesic_tpu.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  Importing a module builds nothing: the native libraries are
compiled on first use (codecs/build.py).
"""
