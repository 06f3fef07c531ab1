from docqa_tpu_torch.text.bpe import (
    BPETokenizer,
    SentencePieceTokenizer,
    load_tokenizer,
)
from docqa_tpu_torch.text.tokenizer import (
    HashTokenizer,
    Tokenizer,
    WordPieceTokenizer,
)

__all__ = [
    "Tokenizer",
    "WordPieceTokenizer",
    "HashTokenizer",
    "BPETokenizer",
    "SentencePieceTokenizer",
    "load_tokenizer",
]
