"""The plain reference that decides a run's ``correct``.

Plain PyTorch in float32 with TF32 off: the MiniLM-width BERT encoder with
an exact cosine top-k (``models.bert_embed``), the Mistral-class decoder run
in blocks (``models.decoder_logits``), its own int8 per-column and grouped
int4 quantisers, and a frozen copy of the hash tokenizer and the ``/ask``
prompt template (``text``).  It imports nothing of the program: everything
it needs it works out again from the inputs the benchmark made.
"""
