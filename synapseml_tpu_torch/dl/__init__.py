from .backbones import (BACKBONES, ResNet, TinyCNN, make_backbone,  # noqa: F401
                        resnet18, resnet50)
from .backbones import (TextClsHead, TextEmbedUnit, TransformerLayerUnit,  # noqa: F401
                        active_seq_mesh, seq_attention_fn, seq_attention_scope,
                        sharded_self_attention)
from .trainer import TrainConfig, Trainer, freeze_mask  # noqa: F401
from .vision import DeepVisionClassifier, DeepVisionModel  # noqa: F401
from .text import (DeepTextClassifier, DeepTextModel,  # noqa: F401
                   TransformerEncoder, hash_tokenize)
