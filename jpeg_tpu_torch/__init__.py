"""jpeg_tpu_torch — the jpeg_tpu codec in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU.

A port of ``jpeg_tpu`` (JAX + Pallas on a TPU), which stays beside it as
the reference: same wire format, same configuration objects, and levels,
streams and planes that agree with the JAX package's f32 path (bitwise,
except +-1 at provable round ties; ``utils/parity.py``).  This package
imports ``torch`` and never ``jax`` or ``jpeg_tpu``.

The image API (``compress_ycbcr`` / ``compress_many``,
``decompress_to_ycbcr`` / ``decompress_to_device`` / ``decompress_many``,
``Jpeg``) and the band API (``compress_band`` / ``decompress_band``) run
hand-written CUDA kernels (``ops/kernels.py``, sources in ``csrc/``), built
with ``nvcc`` at first use.  Decode finds the block boundaries with the
host C++ scan or on the device (``scan=``).  Positional parameters are
the reference's, in its order, ``dtype`` included: ``None`` (f32) or
float64 (``torch.float64``, ``np.float64`` or ``"float64"``), the parity
mode, bit-exact with the reference (small images: its transforms loop over
blocks on the host).  Keyword-only after them: ``device`` everywhere,
``"cuda"`` (default) launches the kernels, ``"cpu"`` runs their plain
PyTorch versions; ``scan`` on the decoders; ``enc`` on ``compress_ycbcr`` /
``compress_many`` / ``Jpeg``: ``"lv"`` (default) or ``"tables"``, two
kernels that write the same stream.  The container helpers and
``padded_size`` are exported as the reference exports them.

``jpeg_tpu_torch.steps`` is the reference's invertible step pipeline (nine
registered steps, ``compress_band_steps`` / ``decompress_band_steps``), with
the reference's class-level objects beside it (``ops/transform.py``: ``DCT``,
``Zigzag``; ``ops/quantize.py``: the quantizer classes;
``entropy/bitio.py``, ``entropy/tuples.py``, ``utils/arrays.py``).

``jpeg_tpu_torch.parallel`` shards batches and row bands over a mesh of
torch devices and stitches the byte-aligned streams (``multihost``: across
processes over ``torch.distributed``); ``python -m jpeg_tpu_torch
{compress|decompress|batch}`` is the CLI; ``utils/profiling.py`` holds
``StageTimer``, ``trace`` and ``Metrics``.
"""

from .config import (BadArrayShapeError, BadQuantizationError,
                     BadRleCodeError, BadStreamError, Configuration,
                     EmptyArrayError, QuantizationMethod, padded_size)
from .container import (CompressedData, create_header, generate_data,
                        get_header, read_data)
from .api import (Jpeg, compress_band, compress_many, compress_ycbcr,
                  decompress_band, decompress_many, decompress_to_device,
                  decompress_to_ycbcr, psnr)
from . import steps  # the reference's step pipeline (steps.step_classes)

__version__ = "0.1.0"

__all__ = [
    "BadArrayShapeError", "BadQuantizationError", "BadRleCodeError",
    "BadStreamError", "CompressedData", "Configuration", "EmptyArrayError",
    "Jpeg", "QuantizationMethod", "compress_band", "compress_many",
    "compress_ycbcr", "create_header", "decompress_band", "decompress_many",
    "decompress_to_device", "decompress_to_ycbcr", "generate_data",
    "get_header", "padded_size", "psnr", "read_data",
]
