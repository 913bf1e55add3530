from .backbones import (TextClsHead, TextEmbedUnit, TransformerLayerUnit,  # noqa: F401
                        active_seq_mesh, seq_attention_fn, seq_attention_scope,
                        sharded_self_attention)
from .text import TransformerEncoder, hash_tokenize  # noqa: F401
