"""cpgisland_tpu_torch — the PyTorch / CUDA port of cpgisland_tpu.

The JAX package (``cpgisland_tpu``) stays the reference; this package mirrors
its module layout (``models/hmm.py`` <-> ``models/hmm.py`` and so on) and
runs on an NVIDIA H100.  What is ported so far, for the flagship 8-state
model: the serving path (FASTA -> symbols -> reduced one-hot Viterbi
through three hand-written CUDA kernels, ``csrc/viterbi_onehot.cu`` ->
CpG island calls -> island file), Baum-Welch training (the chunked E-step
through two more, ``csrc/fb_onehot.cu``; ``pipeline.train_file``) and the
reference's six-argument ``pipeline.run``, in both the
reference-compatible and the clean mode.

Nothing here imports ``jax`` or ``cpgisland_tpu``.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU, where every
kernel wrapper takes its plain PyTorch version.
"""

from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.models.hmm import HmmParams, params_from_numpy
from cpgisland_tpu_torch.utils import chunking, codec

__version__ = "0.1.0"

__all__ = ["HmmParams", "params_from_numpy", "presets", "codec", "chunking", "__version__"]
