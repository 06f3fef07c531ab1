"""The training plane of the port, counterpart of ``docqa_tpu/training``:
the causal-LM step (``train.py``), the NER tagger's trainer and cache
(``ner.py``), contrastive encoder fine-tuning (``encoder.py``),
train-state checkpoints (``checkpoint.py``) and the optimizer chain they
share (``optim.py``)."""

from docqa_tpu_torch.training.train import (  # noqa: F401
    TrainState,
    init_train_state,
    lm_loss,
    make_train_step,
)
