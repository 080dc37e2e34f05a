"""generativemodels_tpu_torch: the PyTorch and CUDA port of generativemodels_tpu.

The JAX package stays the reference; this package mirrors its layout
(ops, networks/blocks, networks/nets, networks/schedulers, inferers,
recipes, utils) in PyTorch, channels-first inside the network with the same
(B, C, *spatial) public layout. Every Pallas TPU kernel on a ported path
becomes a kernel written by hand for Hopper (sources under `csrc/`, built
with nvcc at first use). It imports no JAX.
"""

__version__ = "0.1.0"

from .inferers import DiffusionInferer, LatentDiffusionInferer  # noqa: E402,F401
from .networks.nets import AutoencoderKL, DiffusionModelUNet  # noqa: E402,F401
from .networks.schedulers import (  # noqa: E402,F401
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverMultistepScheduler,
    NoiseSchedules,
    PNDMScheduler,
    Scheduler,
)
