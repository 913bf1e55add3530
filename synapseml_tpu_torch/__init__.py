"""synapseml_tpu_torch — the PyTorch/CUDA port of synapseml_tpu for NVIDIA H100.

The JAX package ``synapseml_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Module paths mirror the JAX package, so a
module's counterpart sits at the same relative path.

Ported so far: the LightGBM classifier path, end to end —
``Table`` → ``assemble_features`` → ``LightGBMClassifier.fit`` →
``train_booster`` → leaf-wise ``grow_tree`` → ``transform`` /
``saveNativeModel``. Its two histogram kernels are hand-written CUDA C++ for
``sm_90a`` (``csrc/hist_kernel.cu``), built with ``nvcc`` at first use.

Every public entry point takes ``device`` (default ``"cuda"``). A CUDA
tensor goes through the hand-written kernel or the call raises; the plain
PyTorch version of a kernel runs only for tensors on the CPU.

  core/    — Params, Table, Estimator/Model, device resolution, logging
  ops/     — quantile binning, histogram kernels and their CUDA build
  gbdt/    — objectives, leaf-wise grower, boosting loop, model strings
  models/  — LightGBMClassifier / LightGBMClassificationModel
  convert  — carry a JAX-trained booster across as numpy arrays
"""

__version__ = "0.1.0"
