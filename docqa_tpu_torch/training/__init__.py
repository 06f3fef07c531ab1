"""Training-side modules of the port.  Only the NER tagger's cache
(``ner.py``: save / load / fingerprint) is here so far; training itself
comes later."""
