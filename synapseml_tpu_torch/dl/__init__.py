from .backbones import (BACKBONES, ResNet, TinyCNN, make_backbone,  # noqa: F401
                        resnet18, resnet50)
from .backbones import (ConvReluUnit, PoolDenseHead, ResNetStem,  # noqa: F401
                        StageGroup, StageSequential, make_staged_backbone,
                        partition_stages, stage_units, staged_text_encoder)
from .backbones import (TextClsHead, TextEmbedUnit, TransformerLayerUnit,  # noqa: F401
                        active_seq_mesh, seq_attention_fn, seq_attention_scope,
                        sharded_self_attention)
from .trainer import TrainConfig, Trainer, freeze_mask  # noqa: F401
from .pipeline import SUPPORTED_MATRIX, fit_pipeline  # noqa: F401
from .vision import DeepVisionClassifier, DeepVisionModel  # noqa: F401
from .text import (DeepTextClassifier, DeepTextModel,  # noqa: F401
                   TransformerEncoder, hash_tokenize)
from .cntk import CNTKModel  # noqa: F401
