"""htk_tpu_torch — the PyTorch/CUDA port of htk_tpu for NVIDIA Hopper.

The same HTK tool names, flags, config keys and file formats as htk_tpu,
with device work in PyTorch and hand-written CUDA kernels for the H100
(`csrc/`). The layout mirrors htk_tpu's, module for module:

  utils/   config, CLI options, numbered errors, filters, log arithmetic
  io/      HTK feature files, MLF labels, MMF models, SLF lattices, dicts
  models/  compiled (struct-of-arrays) HMM sets
  algo/    word-network compilation and token-passing decode
  ops/     Gaussian scoring and the decode kernel's wrapper
  tools/   CLI tools (`python -m htk_tpu_torch.tools.hvite ...`)

Host modules are copies of htk_tpu's numpy code; the package imports
torch and never JAX or htk_tpu.
"""

__version__ = "0.1.0"
