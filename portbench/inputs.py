"""The benchmark's inputs, made from ``--seed``: weights, store rows,
chunk texts and questions.  The program under test and the reference get
the same ones; neither makes its own.

Weights are drawn on the device with a ``torch.Generator`` in a few large
calls, in the type they are served in: one draw a kind of projection for
all layers at once, each layer's leaf a view of it.  Texts and questions
are drawn on the host with numpy; every text has exactly the number of
tokenizer pieces asked for, so every prompt has the same length and every
seed sends the same sizes.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch

from portbench.flops import ModelShape
from portbench.reference.text import pieces


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one input, from the run's seed and the input's name."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, tag))
    return g


def decoder_weights(m: ModelShape, seed: int, device, dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """The decoder tree with the port's leaf names, projections [in, out],
    each drawn ``normal * fan_in ** -0.5``; norm gains ones.

    The values are one draw, the same for every seed, whose hidden units
    (the residual stream) and intermediate units (the MLP's) are then put
    in an order drawn from the seed.  Norm gains are ones, so every seed
    serves the same function with its tensors laid out anew: a random
    decoder's greedy answers loop more or less by draw, which moves the
    drafts that prompt-lookup speculation gets accepted (1.8 to 3.2 tokens
    a verify step between draws), and one function keeps that work the
    same from seed to seed while every leaf still differs."""
    g = _generator(0, "decoder", device)
    kw = dict(generator=g, dtype=dtype, device=device)
    hidden = _permutation(m.hidden, seed, "hidden", device)
    inner = _permutation(m.mlp, seed, "intermediate", device)
    tree: Dict[str, torch.Tensor] = {
        "tok_emb": torch.randn((m.vocab, m.hidden), **kw).mul_(m.hidden ** -0.5)[:, hidden],
        "lm_head": torch.randn((m.hidden, m.vocab), **kw).mul_(m.hidden ** -0.5)[hidden],
    }
    # rows (inputs) and columns (outputs) that are hidden or intermediate units
    order = {"wq": (hidden, None), "wk": (hidden, None), "wv": (hidden, None),
             "wo": (None, hidden), "w_gate": (hidden, inner), "w_up": (hidden, inner),
             "w_down": (inner, hidden)}
    for name, i, o in m.projections():
        stack = torch.randn((m.layers, i, o), **kw).mul_(i ** -0.5)
        rows, cols = order[name]
        for layer in range(m.layers):  # one layer's copy at a time
            w = stack[layer]
            if rows is not None:
                w = w.index_select(0, rows)
            if cols is not None:
                w = w.index_select(1, cols)
            stack[layer].copy_(w)
            tree[f"l{layer}_{name}"] = stack[layer]
    norms = torch.ones((2 * m.layers + 1, m.hidden), dtype=dtype, device=device)
    for layer in range(m.layers):
        tree[f"l{layer}_attn_norm_g"] = norms[2 * layer]
        tree[f"l{layer}_mlp_norm_g"] = norms[2 * layer + 1]
    tree["final_norm_g"] = norms[-1]
    return tree


def _permutation(n: int, seed: int, tag: str, device) -> torch.Tensor:
    return torch.randperm(n, generator=_generator(seed, tag, device), device=device)


def encoder_weights(enc: Dict[str, int], seed: int, device) -> Dict[str, torch.Tensor]:
    """The BERT-class encoder tree with the port's leaf names in float32:
    dense weights and embeddings ``normal * 0.02`` from one draw, biases
    zeros, norm gains ones."""
    h, m, layers = enc["hidden_size"], enc["intermediate_size"], enc["num_hidden_layers"]
    normal = {"tok_emb": (enc["vocab_size"], h), "pos_emb": (enc["max_position_embeddings"], h),
              "type_emb": (2, h)}
    for i in range(layers):
        for n in ("q", "k", "v", "o"):
            normal[f"l{i}_{n}_w"] = (h, h)
        normal[f"l{i}_up_w"], normal[f"l{i}_down_w"] = (h, m), (m, h)
    total = sum(int(np.prod(s)) for s in normal.values())
    flat = torch.randn((total,), generator=_generator(seed, "encoder", device),
                       dtype=torch.float32, device=device).mul_(0.02)
    tree: Dict[str, torch.Tensor] = {}
    at = 0
    for name, s in normal.items():
        n = int(np.prod(s))
        tree[name] = flat[at:at + n].view(s)
        at += n

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    tree["emb_ln_g"], tree["emb_ln_b"] = ones(h), zeros(h)
    for i in range(layers):
        for n in ("q", "k", "v", "o"):
            tree[f"l{i}_{n}_b"] = zeros(h)
        tree[f"l{i}_up_b"], tree[f"l{i}_down_b"] = zeros(m), zeros(h)
        for ln in ("attn_ln", "mlp_ln"):
            tree[f"l{i}_{ln}_g"], tree[f"l{i}_{ln}_b"] = ones(h), zeros(h)
    return tree


def store_vectors(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """The store's rows as drawn, float32 [rows, dim], not yet normalised."""
    return torch.randn((rows, dim), generator=_generator(seed, "store", device),
                       dtype=torch.float32, device=device)


# French clinical vocabulary for the chunk texts and the questions
_SUBJECTS = ("le patient", "la patiente", "le médecin traitant", "l'équipe de soins",
             "le cardiologue", "l'infirmière", "le service des urgences")
_VERBS = ("présente", "signale", "décrit", "rapporte", "confirme", "note", "observe",
          "prescrit", "recommande", "surveille")
_FINDINGS = ("une douleur thoracique", "une dyspnée d'effort", "une fièvre modérée",
             "une toux persistante", "des céphalées", "une asthénie", "des œdèmes des membres",
             "une tension artérielle élevée", "une glycémie instable", "des palpitations",
             "une perte de poids", "des nausées", "une insuffisance rénale débutante")
_DRUGS = ("metformine", "lisinopril", "amlodipine", "atorvastatine", "aspirine",
          "lévothyroxine", "furosémide", "bisoprolol", "insuline glargine", "apixaban")
_TAILS = ("depuis trois jours", "au cours de la consultation", "après le changement de traitement",
          "malgré le régime", "lors du dernier bilan", "sans antécédent connu",
          "avec un suivi prévu dans un mois", "selon le compte rendu de sortie")
_TOPICS = ("l'évolution clinique", "le choix du traitement", "les résultats du bilan",
           "le risque cardiovasculaire", "la tolérance du médicament", "le plan de suivi",
           "les interactions médicamenteuses", "la prise en charge de la douleur")


def _sentence(rng: np.random.Generator) -> str:
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    return (f"{pick(_SUBJECTS)} {pick(_VERBS)} {pick(_FINDINGS)} {pick(_TAILS)}, "
            f"traité par {pick(_DRUGS)} {int(rng.integers(5, 1000))} mg "
            f"{int(rng.integers(1, 4))} fois par jour.")


def _exact_pieces(rng: np.random.Generator, make, n: int) -> str:
    """Pieces of ``make(rng)`` sentences, cut to exactly ``n``, joined so
    the text splits back into the same ``n`` pieces."""
    out: List[str] = []
    while len(out) < n:
        out.extend(pieces(make(rng)))
    return " ".join(out[:n])


def text_pool(seed: int, n: int, tokens: int) -> List[str]:
    """``n`` chunk texts of exactly ``tokens`` pieces each."""
    rng = np.random.default_rng([sub_seed(seed, "texts"), 0])
    return [_exact_pieces(rng, _sentence, tokens) for _ in range(n)]


def questions(seed: int, n: int, tokens: int) -> List[str]:
    """``n`` generative questions ("expliquez ...", a reasoning cue for the
    answer router) of exactly ``tokens`` pieces each."""
    rng = np.random.default_rng([sub_seed(seed, "questions"), 0])

    def make(r):
        pick = lambda xs: xs[int(r.integers(len(xs)))]  # noqa: E731
        return (f"expliquez {pick(_TOPICS)} chez {pick(_SUBJECTS)} qui {pick(_VERBS)} "
                f"{pick(_FINDINGS)} {pick(_TAILS)} sous {pick(_DRUGS)}")

    out = []
    for _ in range(n):
        body = _exact_pieces(rng, make, tokens - 1)
        out.append(body + " ?")
    return out
