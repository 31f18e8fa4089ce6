"""hesic_tpu_torch: the PyTorch/CUDA port of hesic_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (codecs/, datasets/, entropy_models/,
geometry/, layers/, models/, ops/, parallel/, training/, utils/, zoo/) so
each module's counterpart is found by name, and each package exports the
JAX package's public names.
It imports torch and numpy only: nothing of JAX and nothing of hesic_tpu.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  Importing a module builds nothing: the native libraries are
compiled on first use (codecs/build.py).
"""

__version__ = "0.1.0"

# the entropy-coder registry of CompressAI's public API, as the JAX
# package's (hesic_tpu/__init__.py)
_AVAILABLE_ENTROPY_CODERS = ("ans", "rangecoder")
_entropy_coder = "ans"


def available_entropy_coders():
    """List the names of the usable entropy coders."""
    return list(_AVAILABLE_ENTROPY_CODERS)


def get_entropy_coder():
    """Return the name of the default entropy coder."""
    return _entropy_coder


def set_entropy_coder(entropy_coder: str):
    """Set the default entropy coder ('ans' or 'rangecoder')."""
    global _entropy_coder
    if not isinstance(entropy_coder, str):
        raise ValueError(f'Invalid entropy coder type "{type(entropy_coder)}"')
    if entropy_coder not in _AVAILABLE_ENTROPY_CODERS:
        coders = ", ".join(_AVAILABLE_ENTROPY_CODERS)
        raise ValueError(f'Invalid entropy coder "{entropy_coder}", '
                         f"choose from ({coders})")
    _entropy_coder = entropy_coder
