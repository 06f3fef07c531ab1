"""Port parity, the configuration surface: ``docqa_tpu_torch.config``
against ``docqa_tpu.config``.

* Every ``section.field`` of the reference's ``Config`` loads through the
  port's ``load_config``, as an override and as a
  ``DOCQA_<SECTION>__<FIELD>`` variable, with the reference's default and
  the reference's coercion.  ``dispatch.n_lanes`` is the one default kept
  different (the port's spine default, ``engines/spine.DEFAULT_LANES``).
* ``DecoderConfig.llama3_8b()`` equals the reference's field for field, and
  a small decoder at its ``rope_theta`` (500,000) with no window decodes
  the reference's greedy tokens.
* ``dispatch.strict_sync=True`` serialises the spine: two items never
  overlap, on lanes or on their callers.
* The fields with a subject in the port reach it (the registry's table,
  the store's score check, the server's socket timeout); those without
  one are logged at boot when set.
"""

import dataclasses
import logging
import threading
import time

import numpy as np
import pytest
import torch

from docqa_tpu import config as jconfig
from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import GenerateConfig as JGenerateConfig
from docqa_tpu.engines.generate import GenerateEngine as JGenerateEngine
from docqa_tpu_torch import config as pconfig
from docqa_tpu_torch.config import DecoderConfig, GenerateConfig
from docqa_tpu_torch.engines.generate import GenerateEngine
from docqa_tpu_torch.engines.spine import DispatchSpine

torch.set_num_threads(1)

# the one default the port keeps different, and why (its docstring)
KEPT_DIFFERENT = {"dispatch.n_lanes": (2, 8)}


def _fields(cfg):
    out = {}
    for sec in dataclasses.fields(cfg):
        section = getattr(cfg, sec.name)
        for f in dataclasses.fields(section):
            out[f"{sec.name}.{f.name}"] = getattr(section, f.name)
    return out


REF_FIELDS = _fields(jconfig.Config())


def _sample(value):
    """A value of the field's type other than its default, and its
    environment spelling."""
    if isinstance(value, bool):
        return (not value), str(not value).lower()
    if isinstance(value, int):
        return value + 3, str(value + 3)
    if isinstance(value, float):
        return value + 0.25, repr(value + 0.25)
    if isinstance(value, str):
        return value + "x", value + "x"
    if value is None:
        return 7, "7"
    return None, None  # tuples: not settable from the environment


def test_every_reference_field_is_in_the_port():
    port = _fields(pconfig.Config())
    assert sorted(port) == sorted(REF_FIELDS)
    for path, value in REF_FIELDS.items():
        if path in KEPT_DIFFERENT:
            assert (value, port[path]) == KEPT_DIFFERENT[path]
        else:
            assert port[path] == value, path


@pytest.mark.parametrize("path", sorted(REF_FIELDS))
def test_field_loads_by_override_and_environment(path):
    value, raw = _sample(REF_FIELDS[path])
    if value is None:
        value = REF_FIELDS[path]
    ref = _fields(jconfig.load_config(env={}, overrides={path: value}))[path]
    port = _fields(pconfig.load_config(env={}, overrides={path: value}))[path]
    assert port == ref == value
    if raw is None:
        return
    section, _, name = path.partition(".")
    env = {f"DOCQA_{section.upper()}__{name.upper()}": raw}
    ref = _fields(jconfig.load_config(env=env))[path]
    port = _fields(pconfig.load_config(env=env))[path]
    assert port == ref
    assert port != REF_FIELDS[path] or path in KEPT_DIFFERENT


def test_llama3_8b_equals_reference():
    ref = dataclasses.asdict(JDecoderConfig.llama3_8b())
    port = dataclasses.asdict(DecoderConfig.llama3_8b())
    assert port.keys() <= ref.keys()
    assert {k: ref[k] for k in port} == port
    assert (port["vocab_size"], port["rope_theta"], port["sliding_window"],
            port["max_seq_len"]) == (128256, 500000.0, None, 8192)


# a small decoder at Llama-3's rope and window
DEC = dict(vocab_size=256, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, mlp_dim=128, max_seq_len=512,
           dtype="float32", rope_theta=500000.0, sliding_window=None)
GEN = dict(max_new_tokens=12, prefill_buckets=(32, 64, 128))
PROMPTS = [
    [2, 5, 9, 17, 33, 5, 9, 17, 40, 5, 9, 17, 3],
    [2, 7, 7, 8, 100, 3],
    [2] + list(range(10, 80)),
]


@pytest.mark.parametrize("spec_k", [4, 0])
def test_llama3_rope_greedy_tokens_equal_reference(spec_k):
    ref = JGenerateEngine(
        JDecoderConfig(**DEC), JGenerateConfig(**GEN, speculative_k=spec_k), seed=5
    ).generate_ids(PROMPTS)
    port = GenerateEngine(
        DecoderConfig(**DEC), GenerateConfig(**GEN, speculative_k=spec_k),
        seed=5, device="cpu",
    ).generate_ids(PROMPTS)
    assert port == ref


# ---------------------------------------------------------------------------
# strict sync
# ---------------------------------------------------------------------------


def _overlaps(spine, submit_both):
    """Run two 0.2 s items through ``spine``; the peak number executing at
    once."""
    live = [0]
    peak = [0]
    lock = threading.Lock()

    def item():
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.2)
        with lock:
            live[0] -= 1
        return 1

    submit_both(spine, item)
    return peak[0]


def _two_submitted(spine, item):
    tickets = [spine.submit("t", item), spine.submit("t", item)]
    assert [t.result(timeout=10) for t in tickets] == [1, 1]


def _two_issued(spine, item):
    out = []
    threads = [
        threading.Thread(target=lambda: out.append(spine.run("t", item)))
        for _ in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert out == [1, 1]


@pytest.mark.parametrize("submit_both", [_two_submitted, _two_issued],
                         ids=["lanes", "callers"])
def test_strict_sync_serialises_the_spine(submit_both):
    spine = DispatchSpine(n_lanes=4)
    try:
        assert not spine.strict_sync()  # auto: off
        assert _overlaps(spine, submit_both) == 2
        spine.reconfigure(strict_sync=True)  # applies at once
        assert spine.strict_sync()
        assert _overlaps(spine, submit_both) == 1
        spine.reconfigure(strict_sync=False)
        assert _overlaps(spine, submit_both) == 2
    finally:
        spine.close()


# ---------------------------------------------------------------------------
# the fields' subjects in the port
# ---------------------------------------------------------------------------


def test_registry_table_is_the_configured_one(tmp_path):
    import sqlite3

    from docqa_tpu_torch.service.registry import DocumentRegistry

    path = tmp_path / "r.db"
    reg = DocumentRegistry(f"sqlite:///{path}", table="docs_v2")
    rec = reg.create("a.txt", patient_id="p1")
    reg.set_status(rec.doc_id, "INDEXED", n_chunks=2)
    assert reg.get(rec.doc_id).n_chunks == 2
    assert [r.doc_id for r in reg.list_documents(patient_id="p1")] == [rec.doc_id]
    reg.close()
    names = {r[0] for r in sqlite3.connect(path).execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}
    assert names == {"docs_v2"}
    with pytest.raises(ValueError):
        DocumentRegistry(table="documents; DROP TABLE x")


def test_store_score_other_than_cosine_is_refused():
    from docqa_tpu_torch.service.app import check_config

    check_config(pconfig.load_config(env={}))
    with pytest.raises(ValueError, match="cosine"):
        check_config(pconfig.load_config(env={}, overrides={"store.score": "l2"}))


def test_fields_without_a_subject_are_logged_when_set(caplog):
    from docqa_tpu_torch.service.app import check_config

    cfg = pconfig.load_config(env={}, overrides={
        "service.qa_port": 9001, "telemetry.hbm_refresh_s": 5.0})
    assert pconfig.unused_fields(cfg) == {
        "service.qa_port": 9001, "telemetry.hbm_refresh_s": 5.0}
    assert pconfig.unused_fields(pconfig.load_config(env={})) == {}
    with caplog.at_level(logging.INFO):
        check_config(cfg)
    logged = [r.getMessage() for r in caplog.records if "no subject" in r.getMessage()]
    assert len(logged) == 2 and "service.qa_port=9001" in logged[0]


def test_request_timeout_is_the_connection_timeout():
    import socket

    from docqa_tpu_torch.service.app import AppServer

    class App:
        def handle(self, req):
            raise AssertionError("no request is sent")

        def close(self, timeout):
            return True

    server = AppServer(App(), request_timeout_s=0.3).start()
    try:
        conn = socket.create_connection(("127.0.0.1", server.port))
        conn.settimeout(10)
        t0 = time.perf_counter()
        # an idle client is dropped after the timeout: the read sees EOF
        assert conn.recv(1) == b""
        assert time.perf_counter() - t0 < 5
        conn.close()
    finally:
        assert server.close(timeout=10)
    assert np.isfinite(pconfig.Config().service.request_timeout_s)
