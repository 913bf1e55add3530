"""synapseml_tpu_torch — the PyTorch/CUDA port of synapseml_tpu for NVIDIA H100.

The JAX package ``synapseml_tpu`` stays the reference; this package imports
nothing of it and nothing of JAX. Module paths mirror the JAX package, so a
module's counterpart sits at the same relative path.

Ported so far: the LightGBM classifier path, end to end —
``Table`` → ``assemble_features`` → ``LightGBMClassifier.fit`` →
``train_booster`` → leaf-wise ``grow_tree`` → ``transform`` /
``saveNativeModel``, and depthwise growth. Its histogram kernels are
hand-written CUDA C++ for ``sm_90a`` (``csrc/hist_kernel.cu``), built with
``nvcc`` at first use. And the sequence-parallel text encoder forward:
``TransformerEncoder(mask_free=True)`` inside ``seq_attention_scope`` on a
``torch.distributed`` mesh, with ring and Ulysses attention through the
hand-written flash kernels of ``csrc/attention_kernel.cu``. And the text
and vision estimators: ``DeepTextClassifier`` through those kernels,
``DeepVisionClassifier`` on flax-exact ResNets (convolutions and BatchNorm
on cuDNN, outside any TPU kernel in the JAX package too). And the serving
layer: ``Booster.serving_fn`` through the bucketed runner, one captured
CUDA graph per batch bucket, behind the micro-batching HTTP server with hot
swap, tenants and deadlines, and the fabric in front of it: gateways with
membership, routing, failover and federation, workers in every process
of a ``torch.distributed`` world, the promotion broadcast. And ONNX
inference: ``ONNXModel`` scores an ONNX graph's ops as PyTorch calls
inside those captured graphs. And VW's hashed linear learners on the
card, and the online bandit loop around them.

Every public entry point takes ``device`` (default ``"cuda"``). A CUDA
tensor goes through the hand-written kernel or the call raises; the plain
PyTorch version of a kernel runs only for tensors on the CPU.

  core/     — Params, Table, Estimator/Model, device resolution, logging,
              the bucketed inference runner, QoS and resilience primitives
  ops/      — quantile binning, histogram and flash-attention kernels and
              their CUDA build, host image decode and resize
  gbdt/     — objectives, leaf-wise and depthwise growers, boosting loop,
              model strings
  models/   — LightGBMClassifier / LightGBMClassificationModel
  parallel/ — meshes over torch.distributed, seq-axis collectives, ring and
              Ulysses attention
  io/       — the micro-batching HTTP server, its model registry and CLI,
              the serving fabric (gateways, agents, supervisor, broadcast)
  dl/       — flax's layers, ResNets, transformer units, the text encoder,
              the trainer and the text and vision estimators
  onnx/     — the ONNX protobuf reader, the 135-op executor, ONNXModel on
              the runner's CUDA graphs, ImageFeaturizer, the hub, the
              booster's TreeEnsemble export
  vw/       — VW hashing, featurizers, the learner, estimators, policy
              evaluation
  online/   — the feedback log, learner loop, policy, promotion gate and
              streaming anomaly loop
  featurize/, train/, stages/, exploratory/ — Featurize and the indexers,
              TrainClassifier / TrainRegressor and their statistics, the
              pipeline stages and the data-balance measures (host code
              over the port's LightGBM)
  automl/   — TuneHyperparameters, FindBestModel, the elastic halving
              scheduler and its gang of spool workers
  native/   — the C++ host helpers (murmur3 batches, hashing TF, CSV),
              built with g++ at first use
  testing/  — the fault injectors the fabric, online and AutoML scenarios
              drive
  convert   — carry a JAX-trained booster, flax variables or a VW state
              across
"""

__version__ = "0.1.0"
