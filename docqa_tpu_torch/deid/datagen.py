"""Synthetic labeled-PHI generator, counterpart of ``docqa_tpu/deid/datagen.py``
(verbatim, down to ``encode_example`` and ``sample_batch``, the padded
training batches of ``training/ner.py``).

The notes are clinical sentences templated over PHI lexicons.  A fraction
of PERSON/LOCATION fills are random pronounceable syllable strings, the
evaluation lexicons are disjoint from the training ones, and capitalized
non-PHI words appear with O labels, so a tagger trained on them must learn
context and orthographic shape rather than word identity.  The same seed
gives the same notes here and in the reference (numpy ``Generator``).

Label scheme: BIO over ``NERConfig.entities`` (``models/ner.py:label_ids``).
Supervision sits on the FIRST token of each word — the position
``deid/engine.py:_ner_results`` reads logits from at inference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from docqa_tpu_torch.config import NERConfig
from docqa_tpu_torch.models.ner import label_ids
from docqa_tpu_torch.text.tokenizer import ShapeHashTokenizer, Tokenizer, _WORD_RE


def ner_tokenizer(cfg: NERConfig) -> ShapeHashTokenizer:
    """The tokenizer the tagger is trained with — and must serve with."""
    return ShapeHashTokenizer(cfg.vocab_size)


# Bump on any change to the templates/lexicons below: the npz cache
# fingerprint includes it (training/ner.py:_fingerprint), so a tagger
# trained on an older synthetic distribution invalidates instead of
# serving silently.  Must equal the reference's: the fingerprint of a
# cache it wrote is checked against this value.
DATA_VERSION = 2


# ---------------------------------------------------------------------------
# Lexicons.  TRAIN_* feed the generator; EVAL_* are disjoint and only used
# by evaluate_ner / tests to measure generalization to unseen surface forms.
# ---------------------------------------------------------------------------

TRAIN_FIRST = (
    "Liam Olivia Noah Ava Ethan Mia Lucas Amara Hugo Ines Rafael Leila "
    "Mateo Zara Felix Nadia Omar Clara Iris Tariq Ayo Chen Priya Ravi "
    "Sven Astrid Kenji Yuki Pablo Lucia Marta Andrei Elena Dmitri Aisha "
    "Kofi Abena Thandi Sipho Marco Giulia Pierre Camille Anya Viktor "
    "Soren Maren Tomas Eva Milan Petra Janek Alma Ruben Noor Idris Salma"
).split()
EVAL_FIRST = (
    "John Emma Carlos Fatima Wei Hannah Diego Sofia Ahmed Grace James "
    "Mary Robert Linda Kwame Ingrid"
).split()

TRAIN_LAST = (
    "Moreau Lindqvist Okafor Tanaka Alvarez Petrov Haddad Kowalski Banda "
    "Ferreira Novak Eriksen Demir Fontaine Iqbal Mensah Vargas Bergman "
    "Castellano Dubois Yamamoto Abebe Olsen Marchetti Reyes Sokolov "
    "Amani Laurent Bakker Jensen Costa Weber Ricci Andersson Horvat "
    "Nakamura Osei Traore Lefevre Lombardi"
).split()
EVAL_LAST = (
    "Smith Johnson Williams Brown Garcia Miller Chen Patel Nguyen Keller"
).split()

TRAIN_CITY = (
    "Lyon Marseille Toulouse Hamburg Munich Valencia Porto Antwerp Ghent "
    "Krakow Gdansk Brno Zagreb Vilnius Tampere Aarhus Malmo Bergen "
    "Nagoya Osaka Busan Hanoi Mumbai Pune Lagos Accra Nairobi Kampala "
    "Quito Lima Cordoba Montevideo Calgary Halifax Adelaide Perth "
    "Geneva Basel Utrecht Leiden"
).split()
EVAL_CITY = (
    "Boston Madrid Cairo Dublin Oslo Seattle Toronto Melbourne Kyoto "
    "Casablanca"
).split()

TRAIN_NRP = (
    "French German Spanish Polish Czech Croatian Finnish Danish Japanese "
    "Korean Vietnamese Indian Nigerian Ghanaian Kenyan Peruvian Canadian "
    "Australian Swiss Dutch Catholic Protestant Orthodox Muslim Hindu "
    "Sikh Jain Lutheran Anglican Methodist Quaker Mormon Amish Baptist "
    "Presbyterian Taoist Mennonite"
).split() + [
    # multi-word affiliations: span merging must learn B- then I- chains
    "Roman Catholic",
    "Greek Orthodox",
    "Seventh-day Adventist",
    "Russian Orthodox",
]
EVAL_NRP = "Irish Buddhist Norwegian Egyptian Moroccan Jewish".split()

# Capitalized non-PHI that must stay O (drugs, scans, units, days are caught
# by the DATE_TIME pattern recognizer, not the tagger).
_CAP_NEGATIVES = (
    "Lisinopril Metformin Atorvastatin Tylenol Ibuprofen Warfarin "
    "Amoxicillin Prednisone Insulin Albuterol"
).split()
_SCANS = "MRI CT ECG EEG X-ray".split()

_LOCATION_PREFIXES = (
    "New Port Mount East West Saint Lake Fort North South"
).split()

# Sentence-initial discourse openers — capitalized O-words that must
# co-occur WITH entities in training.  The round-4 disjoint eval showed the
# tagger had learned "TITLE-shaped word in a PHI-bearing sentence ⇒
# PERSON": pure no-PHI negatives taught it nothing about "On examination
# <PERSON> ..." (every observed false positive was a sentence-initial or
# header capital in a sentence that also contained a real entity).
_OPENERS = (
    "Today Tonight Overnight Currently Notably Meanwhile Subsequently "
    "Thereafter Yesterday Accordingly Additionally Otherwise Regardless "
    "Afterwards Initially"
).split()

_SYLLABLES = (
    "ba be bi bo bu da de di do du ka ke ki ko ku la le li lo lu ma me "
    "mi mo mu na ne ni no nu ra re ri ro ru sa se si so su ta te ti to "
    "tu va ve vi vo vu za ze zi zo zu"
).split()


def _gibberish(rng: np.random.Generator) -> str:
    n = int(rng.integers(2, 4))
    word = "".join(rng.choice(_SYLLABLES) for _ in range(n))
    return word.capitalize()


# ---------------------------------------------------------------------------
# Sentence templates.  {P}=PERSON {L}=LOCATION {N}=NRP {D}=capitalized O-word
# {S}=scan-type O-word.  Entity spans are computed by construction.
# ---------------------------------------------------------------------------

# Compositional clause bank: subjects x predicates gives combinatorial
# coverage of entity-in-context positions.  Fixed whole-sentence templates
# alone left composition gaps — a tagger trained on "Patient {P} was
# admitted..." AND "{P} from {L} presented..." still missed the live
# composition "Patient {P} from {L} was admitted on <date>..." (observed in
# the round-2 service drive).
_SUBJECTS: Tuple[str, ...] = (
    "Patient {P}",
    "{P}",
    "Mr {P}",
    "Ms {P}",
    "Dr {P}",
    "Spouse {P}",
    "Daughter {P}",
    "Caregiver {P}",
    "{P} from {L}",
    "Patient {P} from {L}",
    "{P} of {L}",
    "{P}, a {N} male,",
    "{P}, a {N} female,",
    "Patient {P}, who is {N},",
    # appositions and narrative subjects (round-3 disjoint eval showed the
    # tagger under-trained on flowing prose: deid/evalset.py)
    "The patient, {P},",
    "Our mutual patient {P}",
    "Your patient {P}",
    "The surgeon, {P},",
    "pt {P}",
)
_PREDICATES: Tuple[str, ...] = (
    "was admitted with chest pain.",
    "was admitted on Monday with shortness of breath.",
    "reports worsening dyspnea over two days.",
    "presented to the emergency department.",
    "was seen today in clinic.",
    "denies tobacco use.",
    "has a history of hypertension.",
    "will follow up in two weeks.",
    "was discharged home in stable condition.",
    "requests an interpreter for the next visit.",
    "tolerated the procedure well.",
    "reports good adherence to medications.",
    # predicates carrying their own entities (late-sentence positions)
    "was transferred from {L} for a higher level of care.",
    "will be discharged to a rehabilitation facility in {L}.",
    "arrived by ambulance from {L} overnight.",
    "is resting comfortably, family at bedside.",
)

_TEMPLATES: Tuple[str, ...] = (
    # fixed forms the clause bank cannot express (entity mid/late sentence,
    # multi-entity, possessives)
    "{P} lives in {L} with family.",
    "{P} resides in {L} and works as a teacher.",
    "Discussed the discharge plan with {P} today.",
    "The patient identifies as {N} and requests an interpreter.",
    "{P} recently traveled to {L} for work.",
    "Patient transferred from a clinic in {L}.",
    "Per {P}, symptoms began after returning from {L}.",
    "{P} of {N} descent presented for follow-up.",
    "{P} moved to {L} last year.",
    "History obtained from {P}, the patient's brother.",
    # short intake-header forms (sentence-initial entities, minimal context)
    "{P} from {L}.",
    "{P} lives in {L}.",
    "Name: {P}.",
    "Address: {L}.",
    "Emergency contact: {P}, number on file.",
    "Referred by {P}.",
    "{P} and spouse attended the visit.",
    # letter register (salutations, courteous clauses)
    "Dear colleague, thank you for referring {P} for further evaluation.",
    "Thank you for asking me to see {P} in consultation.",
    "I had the pleasure of seeing {P}, who travelled from {L}.",
    "I reviewed the results with {P} by telephone yesterday.",
    # possessives (the span ends at the name; 's stays O)
    "{P}'s blood pressure remains elevated despite therapy.",
    "{P}'s family requests a care conference this week.",
    # religious-practice phrasings (affiliation in varied predicates)
    "He is a devout {N} and declines the gelatin-based capsules.",
    "She is an active member of the local {N} congregation.",
    "Patient describes himself as {N} and requests chaplain support.",
    "Faith is recorded as {N} in the chart.",
    "A practicing {N}, the patient observes dietary restrictions.",
    # French clinical prose (the service's prompt language)
    "La patiente {P} de {L} consulte pour des céphalées persistantes.",
    "Monsieur {P} habite {L} et vit seul depuis peu.",
    "Madame {P} est hospitalisée depuis hier soir.",
    "Le patient {P}, d'origine {N}, est suivi en cardiologie.",
    # negatives: no PHI, plenty of capitalized O words
    "Patient presents with abdominal pain and nausea.",
    "The {S} of the chest was unremarkable.",
    "Started on {D} 10 mg daily.",
    "Continue {D} and recheck labs in the morning.",
    "Labs were drawn at the bedside without complication.",
    "Physical exam reveals no acute distress.",
    "{S} results were reviewed with the care team.",
    "Plan to titrate {D} as tolerated.",
    # narrative negatives: sentence-initial capitals, section headers,
    # clinical nouns that must not fire as PERSON/LOCATION
    "Assessment: stable overnight. Plan: continue current regimen.",
    "Ambulating independently; wound edges clean and dry.",
    "Chest radiograph demonstrates clear lung fields bilaterally.",
    "Colonoscopy scheduled for next month; bowel preparation reviewed.",
    "Echocardiogram pending; telemetry without events overnight.",
    "Discharge instructions reviewed; follow-up arranged with cardiology.",
    # capitalized O-words CO-OCCURRING with entities (see _OPENERS note):
    # discourse openers, chart headers, and clinical nouns in PHI-bearing
    # sentences — the composition the false positives came from
    "{O}, {P} was reviewed by the team.",
    "{O} {P} remains afebrile on the current regimen.",
    "{O}, the team updated {P} at the bedside.",
    "On examination, {P} appears comfortable and alert.",
    "On arrival {P} was triaged promptly.",
    "We evaluated {P} in the urgent care area.",
    "We discussed goals of care with {P} at length.",
    "Next of kin: {P}.",
    "Next of kin: {P}. Residence: {L}.",
    "Religion: {N}. Interpreter not required.",
    "Night float note - {P} slept through rounds.",
    "At 0700 rounds, pt {P} was alert and oriented.",
    "Telemetry reviewed; {P} without ectopy overnight.",
    "Echocardiogram reviewed with {P} at the bedside.",
    "Labs pending; {P} tolerating a regular diet.",
    "Plan discussed with {P}; questions answered.",
    "Family of {P} updated by telephone this evening.",
    "Review of systems otherwise negative for {P}.",
    "Occupation: retired engineer; lives near {L}.",
    "The {S} for {P} was rescheduled to Friday.",
    "Continue {D}; {P} will recheck labs next week.",
)


def _fill(
    rng: np.random.Generator,
    template: str,
    lexicons: Dict[str, Sequence[str]],
    gibberish_frac: float,
) -> Tuple[str, List[Tuple[int, int, str]]]:
    """Render one template → (text, [(char_start, char_end, entity)])."""
    out: List[str] = []
    spans: List[Tuple[int, int, str]] = []
    pos = 0
    i = 0
    while i < len(template):
        if template[i] == "{" and i + 2 < len(template) and template[i + 2] == "}":
            slot = template[i + 1]
            if slot == "P":
                use_gib = rng.random() < gibberish_frac
                first = _gibberish(rng) if use_gib else str(rng.choice(lexicons["first"]))
                if rng.random() < 0.7:
                    last = _gibberish(rng) if use_gib else str(rng.choice(lexicons["last"]))
                    fill = f"{first} {last}"
                else:
                    fill = first
                ent = "PERSON"
            elif slot == "L":
                fill = (
                    _gibberish(rng)
                    if rng.random() < gibberish_frac
                    else str(rng.choice(lexicons["city"]))
                )
                if rng.random() < 0.2:
                    # compound place names (Mount Auburn, New Bedford —
                    # multi-word LOCATION spans the tagger must chain)
                    fill = (
                        str(rng.choice(_LOCATION_PREFIXES)) + " " + fill
                    )
                ent = "LOCATION"
            elif slot == "N":
                # gibberish NRP fills too (at a lower rate): group names
                # form a near-closed set, but an unseen affiliation must
                # still be typed NRP from context — without these, unseen
                # hash buckets fall back to the (much larger) PERSON prior
                fill = (
                    _gibberish(rng)
                    if rng.random() < 0.25 * gibberish_frac
                    else str(rng.choice(lexicons["nrp"]))
                )
                ent = "NRP"
            elif slot == "D":
                fill, ent = str(rng.choice(_CAP_NEGATIVES)), None
            elif slot == "S":
                fill, ent = str(rng.choice(_SCANS)), None
            elif slot == "O":
                fill, ent = str(rng.choice(_OPENERS)), None
            else:  # pragma: no cover - template typo guard
                raise ValueError(f"unknown slot {{{slot}}}")
            if ent is not None:
                spans.append((pos, pos + len(fill), ent))
            out.append(fill)
            pos += len(fill)
            i += 3
        else:
            out.append(template[i])
            pos += 1
            i += 1
    return "".join(out), spans


TRAIN_LEXICONS: Dict[str, Sequence[str]] = {
    "first": TRAIN_FIRST, "last": TRAIN_LAST, "city": TRAIN_CITY, "nrp": TRAIN_NRP,
}
EVAL_LEXICONS: Dict[str, Sequence[str]] = {
    "first": EVAL_FIRST, "last": EVAL_LAST, "city": EVAL_CITY, "nrp": EVAL_NRP,
}


def generate_example(
    rng: np.random.Generator,
    lexicons: Dict[str, Sequence[str]] = TRAIN_LEXICONS,
    max_sentences: int = 3,
    gibberish_frac: float = 0.35,
) -> Tuple[str, List[Tuple[int, int, str]]]:
    """A 1..max_sentences synthetic note with char-level entity spans."""
    n = int(rng.integers(1, max_sentences + 1))
    parts: List[str] = []
    spans: List[Tuple[int, int, str]] = []
    offset = 0
    for _ in range(n):
        if rng.random() < 0.5:  # compositional subject + predicate
            tmpl = (
                str(rng.choice(_SUBJECTS)) + " " + str(rng.choice(_PREDICATES))
            )
        else:
            tmpl = str(rng.choice(_TEMPLATES))
        text, s = _fill(rng, tmpl, lexicons, gibberish_frac)
        parts.append(text)
        spans.extend((a + offset, b + offset, e) for a, b, e in s)
        offset += len(text) + 1  # the join space
    return " ".join(parts), spans


def word_bio_labels(
    text: str, spans: Sequence[Tuple[int, int, str]], cfg: NERConfig
) -> Tuple[List[str], List[Tuple[int, int]], List[int]]:
    """Split text into words and assign BIO label ids per word."""
    lids = label_ids(cfg)
    words: List[str] = []
    wspans: List[Tuple[int, int]] = []
    labels: List[int] = []
    for m in _WORD_RE.finditer(text):
        words.append(m.group())
        wspans.append((m.start(), m.end()))
        label = lids["O"]
        for a, b, ent in spans:
            if m.start() >= a and m.end() <= b:
                prefix = "B" if m.start() == a else "I"
                label = lids[f"{prefix}-{ent}"]
                break
        labels.append(label)
    return words, wspans, labels


def encode_example(
    tokenizer: Tokenizer,
    cfg: NERConfig,
    text: str,
    spans: Sequence[Tuple[int, int, str]],
    seq: int,
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """(ids[seq], length, labels[seq], mask[seq]) — label/mask on the first
    token of each word, mirroring the read position in
    ``deid/engine.py:_ner_results``."""
    words, _, wlabels = word_bio_labels(text, spans, cfg)
    ids = np.zeros((seq,), np.int32)
    labels = np.zeros((seq,), np.int32)
    mask = np.zeros((seq,), np.float32)
    row: List[int] = [tokenizer.cls_id]
    supervise: List[Tuple[int, int]] = []  # (token_idx, label)
    for word, lab in zip(words, wlabels):
        wids = tokenizer.word_to_ids(word)
        if len(row) + len(wids) > seq - 1:
            break
        supervise.append((len(row), lab))
        row.extend(wids)
    row.append(tokenizer.sep_id)
    ids[: len(row)] = row
    for ti, lab in supervise:
        labels[ti] = lab
        mask[ti] = 1.0
    return ids, len(row), labels, mask


def sample_batch(
    rng: np.random.Generator,
    tokenizer: Tokenizer,
    cfg: NERConfig,
    batch_size: int,
    seq: int,
    lexicons: Dict[str, Sequence[str]] = TRAIN_LEXICONS,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """A padded training batch: ids [b,s], lengths [b], labels [b,s],
    mask [b,s]."""
    ids = np.zeros((batch_size, seq), np.int32)
    lengths = np.zeros((batch_size,), np.int32)
    labels = np.zeros((batch_size, seq), np.int32)
    mask = np.zeros((batch_size, seq), np.float32)
    for i in range(batch_size):
        text, spans = generate_example(rng, lexicons)
        ids[i], lengths[i], labels[i], mask[i] = encode_example(
            tokenizer, cfg, text, spans, seq
        )
    return ids, lengths, labels, mask
