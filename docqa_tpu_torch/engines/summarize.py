"""Clinical summarization engine, counterpart of
``docqa_tpu/engines/summarize.py``.  On the default ``decoder`` backend:
instruction-prompted decoding on the port's ``GenerateEngine``, through its
batcher (the runtime's ``EnginePool``) when one is wired, as batch-class
work.  On the ``seq2seq`` backend (``instruction_prompts=False``): the raw
packed documents go to a ``Seq2SeqEngine``, which is trained to summarize
source text (a template would be summarized as content).

Inputs are packed token-aware: each document block gets a share of the
token budget by water-filling (shortest first) and is trimmed at a word
boundary, so no document is dropped and the packed total stays within
budget.  The fake mode (``use_fake``) keeps the reference's semantics: the
prompt's last ``fake_max_chars`` characters.  Templates, packing and trims
are the reference's, so the same generator tokenizer gives the same
prompts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from docqa_tpu_torch.config import SummarizerConfig
from docqa_tpu_torch.engines.serve import DEFAULT_RESULT_TIMEOUT
from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, span

SINGLE_PATIENT_TEMPLATE = (
    "Tu es un assistant clinique. À partir des extraits du dossier du patient "
    "{patient_id} ci-dessous, rédige une synthèse structurée en quatre parties: "
    "1) Contexte clinique, 2) Éléments marquants, 3) Évolution, 4) Points de "
    "vigilance. Réponds uniquement en texte (pas de JSON).\n\n"
    "Extraits du dossier:\n{documents}\n\nSynthèse:"
)

MULTI_PATIENT_TEMPLATE = (
    "Tu es un assistant clinique. Compare les dossiers des patients suivants. "
    "Pour chaque patient, dégage les éléments cliniques essentiels, puis liste "
    "les différences notables et les risques partagés. Réponds uniquement en "
    "texte (pas de JSON).\n\n{documents}\n\nSynthèse comparative:"
)


class SummarizeEngine:
    def __init__(
        self,
        generator,  # GenerateEngine or Seq2SeqEngine (tokenizer + generate_texts)
        cfg: Optional[SummarizerConfig] = None,
        use_fake: bool = False,
        fake_max_chars: int = 1200,
        batcher=None,  # EnginePool or ContinuousBatcher
        instruction_prompts: bool = True,
    ) -> None:
        """``instruction_prompts``: wrap inputs in the clinical instruction
        templates (right for an instruction-following causal LM); the
        seq2seq backend passes False and feeds the packed documents."""
        self.generator = generator
        self.cfg = cfg or SummarizerConfig()
        self.use_fake = use_fake
        self.fake_max_chars = fake_max_chars
        self.batcher = batcher
        self.instruction_prompts = instruction_prompts

    def _pack_documents(
        self, docs: Sequence[Tuple[str, str]], budget_tokens: int
    ) -> str:
        """[(doc_id, text)] -> one prompt block within ``budget_tokens``."""
        docs = list(docs)[: self.cfg.max_chunks]
        if not docs:
            return ""
        tok = self.generator.tokenizer
        lengths = [max(1, len(tok.encode(t, add_specials=False))) for _, t in docs]
        shares = [0] * len(docs)
        remaining = budget_tokens
        order = sorted(range(len(docs)), key=lambda i: lengths[i])
        for pos, i in enumerate(order):
            fair = remaining // (len(docs) - pos)
            shares[i] = min(lengths[i], fair)
            remaining -= shares[i]
        blocks: List[str] = []
        for (doc_id, text), n_tok, share in zip(docs, lengths, shares):
            if n_tok > share:
                # trim at a word boundary; the 0.95 margin absorbs the
                # char-to-token ratio's drift in the trimmed slice
                approx_chars = int(len(text) * 0.95 * share / n_tok)
                cut = text.rfind(" ", 0, approx_chars)
                text = text[: cut if cut > 0 else approx_chars] + " …"
            blocks.append(f"[{doc_id}]\n{text}")
        return "\n\n".join(blocks)

    def _doc_budget(self, template: str, overhead_chars: int = 64) -> int:
        """Token budget left for documents after the instruction template."""
        t_tok = len(self.generator.tokenizer.encode(template, add_specials=False))
        return max(256, self.cfg.max_input_tokens - t_tok - overhead_chars)

    def submit_prompt(self, prompt: str, max_tokens: Optional[int] = None):
        """Queue a summary of a free-form prompt (``/api/llm/summarize``):
        the final ``str`` (fake mode, or no batcher) or a batcher handle;
        pass it to :meth:`resolve`."""
        if self.use_fake:
            return prompt[-self.fake_max_chars :]
        max_tokens = max_tokens or self.cfg.max_summary_tokens
        if self.batcher is not None:
            # summaries are throughput work, never interactive spend
            return self.batcher.submit_text(prompt, max_tokens, req_class="batch")
        with span("summarize", DEFAULT_REGISTRY):
            return self.generator.generate_texts(
                [prompt], max_new_tokens=max_tokens
            )[0]

    def resolve(
        self, pending, timeout: Optional[float] = DEFAULT_RESULT_TIMEOUT
    ) -> str:
        if isinstance(pending, str):
            return pending
        return pending.text(self.generator.tokenizer, timeout)

    def submit_patient(
        self,
        patient_id: str,
        docs: Sequence[Tuple[str, str]],
        max_tokens: Optional[int] = None,
    ):
        template = (
            SINGLE_PATIENT_TEMPLATE if self.instruction_prompts else "{documents}"
        )
        body = self._pack_documents(docs, self._doc_budget(template))
        prompt = (
            template.format(patient_id=patient_id, documents=body)
            if self.instruction_prompts
            else body
        )
        return self.submit_prompt(prompt, max_tokens)

    def submit_compare(
        self,
        patient_docs: Sequence[Tuple[str, Sequence[Tuple[str, str]]]],
        max_tokens: Optional[int] = None,
    ):
        """[(patient_id, [(doc_id, text)])] -> pending comparative summary,
        one ``=== PATIENT x ===`` block per patient."""
        template = (
            MULTI_PATIENT_TEMPLATE if self.instruction_prompts else "{documents}"
        )
        per_patient = self._doc_budget(template) // max(1, len(patient_docs))
        sections = [
            f"=== PATIENT {pid} ===\n{self._pack_documents(docs, per_patient)}"
            for pid, docs in patient_docs
        ]
        prompt = template.format(documents="\n\n".join(sections))
        return self.submit_prompt(prompt, max_tokens)

    def summarize_prompt(self, prompt: str, max_tokens: Optional[int] = None) -> str:
        """Free-form prompt -> summary text."""
        return self.resolve(self.submit_prompt(prompt, max_tokens))

    def summarize_patient(
        self,
        patient_id: str,
        docs: Sequence[Tuple[str, str]],
        max_tokens: Optional[int] = None,
    ) -> str:
        return self.resolve(self.submit_patient(patient_id, docs, max_tokens))

    def compare_patients(
        self,
        patient_docs: Sequence[Tuple[str, Sequence[Tuple[str, str]]]],
        max_tokens: Optional[int] = None,
    ) -> str:
        return self.resolve(self.submit_compare(patient_docs, max_tokens))
