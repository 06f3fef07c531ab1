from docqa_tpu_torch.models.encoder import encode_batch, encoder_forward
from docqa_tpu_torch.models.hf_checkpoint import (
    generate_engine_from_dir,
    load_checkpoint_dir,
)

__all__ = [
    "encoder_forward",
    "encode_batch",
    "load_checkpoint_dir",
    "generate_engine_from_dir",
]
