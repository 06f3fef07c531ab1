"""ledger-audit: runtime witness of resource acquire/release/retire.

Counterpart of ``docqa_tpu/analysis/ledger_audit.py``.  The resource-flow
checker proves lifecycle locally (every path of a function releases what
it acquired); ownership that ESCAPES — a table registered into a slot, a
cost record handed to the trace — is exactly what it cannot follow.  This
witness covers that half at runtime, the way ``race_witness`` covers lock
orderings the static graph models:

* ``engines/paged.py``'s ``BlockAllocator.new_table`` /
  ``BlockTable.release`` are wrapped — every KV table's creation records
  its CALL SITE (the same ``path:lineno`` ids
  ``resource_flow.static_sites`` enumerates), and a table still live at
  quiesce is a leak with the acquiring site named;
* ``obs/costs.py``'s ``RequestCostLedger.open`` / ``retire`` are wrapped —
  a record opened and never retired is a stranded request; redundant
  retires (the ledger's first-caller-wins absorbing an idempotent second
  call) are counted but not failures — several shed paths retire
  defensively by design.

``snapshot()`` cross-checks **witnessed ⊆ static**: every witnessed
acquire/release site must be one the static protocol table knows.  A
witnessed site missing from static means resource-flow never analyzed
that acquire — a blind spot to fix or declare, otherwise the static
gate quietly vouches for lifecycles it never walked.

The gate (the tests and ``chip_smoke.py``'s witness phase; a served
process exposes the same dump at ``GET /api/ledger`` when booted with
``DOCQA_LEDGER_WITNESS=1``): after quiesce, live tables, unretired
records, or witnessed-site blind spots fail the run.  Overhead is a dict
update per table/record lifecycle event — nothing per token — but it is
still opt-in and never belongs in a latency benchmark.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Tuple

# stack frames from these files are machinery, not call sites
_SKIP_FRAME_PARTS = ("ledger_audit.py",)

# witnessed call-site lines may sit a couple of lines off the static
# Call node's anchor (decorators, multi-line calls); match within this
_LINE_TOLERANCE = 2


def build_site_map(
    paths: Optional[List[str]] = None,
) -> Dict[str, Dict[Tuple[str, int], Dict[str, str]]]:
    """protocol -> (abspath, lineno) -> site info, from the SAME
    protocol table resource-flow checks.  ``paths`` defaults to the
    installed ``docqa_tpu_torch`` package — the same scope as ``python -m
    docqa_tpu_torch.analysis``."""
    from docqa_tpu_torch.analysis.core import Package, package_dir
    from docqa_tpu_torch.analysis.resource_flow import static_sites

    if paths is None:
        paths = [package_dir()]
    out: Dict[str, Dict[Tuple[str, int], Dict[str, str]]] = {}
    for root in paths:
        sites = static_sites(Package.load(root))
        for proto, rows in sites.items():
            table = out.setdefault(proto, {})
            for row in rows:
                key = (os.path.abspath(row["path"]), int(row["line"]))
                table[key] = {
                    "kind": row["kind"],
                    "symbol": row["symbol"],
                    "relpath": row["relpath"],
                }
    return out


def _site_known(
    table: Dict[Tuple[str, int], Dict[str, str]],
    site: Tuple[str, int],
) -> bool:
    path, line = site
    for d in range(_LINE_TOLERANCE + 1):
        if (path, line - d) in table or (path, line + d) in table:
            return True
    return False


class LedgerWitness:
    """Records every KV-table and cost-record lifecycle event."""

    def __init__(
        self,
        site_map: Optional[
            Dict[str, Dict[Tuple[str, int], Dict[str, str]]]
        ] = None,
    ) -> None:
        self.site_map = site_map or {}
        # the REAL primitive, pre-patch: when the race witness is also
        # installed (the witness phase runs both), a wrapped _mu would inject
        # witness-internal lock-order edges into ITS graph
        from docqa_tpu_torch.analysis.race_witness import _REAL_LOCK

        self._mu = _REAL_LOCK()
        self._seq = 0
        # id(obj) -> {"seq", "site", "symbol"} while live
        self.live_tables: Dict[int, Dict[str, Any]] = {}
        self.live_records: Dict[int, Dict[str, Any]] = {}
        self.counts: Dict[str, int] = {
            "tables_created": 0,
            "tables_released": 0,
            "tables_release_redundant": 0,  # released-table release (safe)
            "tables_release_untracked": 0,  # created before install
            "records_opened": 0,
            "records_retired": 0,
            "records_retire_redundant": 0,  # first-caller-wins absorbed
        }
        # (protocol, abspath, lineno) -> event count
        self.sites: Dict[Tuple[str, str, int], int] = {}
        # (abspath, lineno) -> retires a record had already absorbed
        self.redundant_retires: Dict[Tuple[str, int], int] = {}
        self._installed = False
        self._orig: Dict[str, Any] = {}

    # ---- recording -----------------------------------------------------------

    def _call_site(self) -> Tuple[str, int]:
        import sys

        frame = sys._getframe(2)
        while frame is not None:
            fname = frame.f_code.co_filename
            if not any(
                p in fname for p in _SKIP_FRAME_PARTS
            ) and not fname.startswith("<"):
                break
            frame = frame.f_back
        if frame is None:
            return ("<unknown>", 0)
        return (os.path.abspath(frame.f_code.co_filename), frame.f_lineno)

    def _event(
        self, proto: str, site: Tuple[str, int]
    ) -> None:
        key = (proto, site[0], site[1])
        self.sites[key] = self.sites.get(key, 0) + 1

    def on_table_created(self, table: Any) -> None:
        site = self._call_site()
        with self._mu:
            self._seq += 1
            self.counts["tables_created"] += 1
            self._event("kv-table", site)
            self.live_tables[id(table)] = {
                "seq": self._seq,
                "site": f"{site[0]}:{site[1]}",
            }

    def on_table_released(self, table: Any, was_released: bool) -> None:
        site = self._call_site()
        with self._mu:
            self._event("kv-table", site)
            if was_released:
                # BlockTable.release is idempotent by design (retire /
                # stop-sweep / failover may all reach a table) — count,
                # don't fail
                self.counts["tables_release_redundant"] += 1
                return
            if self.live_tables.pop(id(table), None) is None:
                self.counts["tables_release_untracked"] += 1
            self.counts["tables_released"] += 1

    def on_record_opened(self, rec: Any) -> None:
        site = self._call_site()
        with self._mu:
            self._seq += 1
            self.counts["records_opened"] += 1
            self._event("cost-record", site)
            self.live_records[id(rec)] = {
                "seq": self._seq,
                "site": f"{site[0]}:{site[1]}",
                "cls": getattr(rec, "cls", "?"),
            }

    def on_record_retired(self, rec: Any, folded: bool) -> None:
        site = self._call_site()
        with self._mu:
            self._event("cost-record", site)
            if folded:
                self.counts["records_retired"] += 1
            else:
                self.counts["records_retire_redundant"] += 1
                self.redundant_retires[site] = self.redundant_retires.get(site, 0) + 1
            self.live_records.pop(id(rec), None)

    # ---- results -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            counts = dict(self.counts)
            leaked = sorted(
                self.live_tables.values(), key=lambda r: r["seq"]
            )
            unretired = sorted(
                self.live_records.values(), key=lambda r: r["seq"]
            )
            site_items = sorted(self.sites.items())
            redundant = sorted(self.redundant_retires.items())
        missing: List[Dict[str, Any]] = []
        witnessed = []
        for (proto, path, line), n in site_items:
            row = {
                "protocol": proto,
                "site": f"{path}:{line}",
                "events": n,
            }
            witnessed.append(row)
            table = self.site_map.get(proto, {})
            if self.site_map and not _site_known(table, (path, line)):
                missing.append(row)
        return {
            "counts": counts,
            "leaked_tables": leaked,
            "unretired_records": unretired,
            "witnessed_sites": witnessed,
            "static_site_count": sum(
                len(t) for t in self.site_map.values()
            ),
            "sites_missing_from_static": missing,
            "redundant_retire_sites": [
                {"site": f"{path}:{line}", "events": n}
                for (path, line), n in redundant
            ],
        }

    # ---- installation --------------------------------------------------------

    def install(self) -> "LedgerWitness":
        """Wrap the lifecycle funnels.  Unlike race_witness this patches
        bound class methods, not factories, so it also covers objects
        whose classes were imported before install."""
        if self._installed:
            return self
        self._installed = True
        witness = self

        from docqa_tpu_torch.engines import paged
        from docqa_tpu_torch.obs import costs

        orig_new_table = paged.BlockAllocator.new_table
        orig_release = paged.BlockTable.release
        orig_open = costs.RequestCostLedger.open
        orig_retire = costs.RequestCostLedger.retire
        self._orig = {
            "new_table": orig_new_table,
            "release": orig_release,
            "open": orig_open,
            "retire": orig_retire,
        }

        def new_table(self):
            table = orig_new_table(self)
            witness.on_table_created(table)
            return table

        def release(self):
            was = bool(self.released)
            orig_release(self)
            witness.on_table_released(self, was)

        def open(self, *a, **kw):
            rec = orig_open(self, *a, **kw)
            if rec is not None:
                witness.on_record_opened(rec)
            return rec

        def retire(self, rec, outcome="ok"):
            folded = orig_retire(self, rec, outcome)
            if rec is not None:
                witness.on_record_retired(rec, folded)
            return folded

        paged.BlockAllocator.new_table = new_table
        paged.BlockTable.release = release
        costs.RequestCostLedger.open = open
        costs.RequestCostLedger.retire = retire
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        from docqa_tpu_torch.engines import paged
        from docqa_tpu_torch.obs import costs

        paged.BlockAllocator.new_table = self._orig["new_table"]
        paged.BlockTable.release = self._orig["release"]
        costs.RequestCostLedger.open = self._orig["open"]
        costs.RequestCostLedger.retire = self._orig["retire"]


# ---------------------------------------------------------------------------
# module-level convenience (the app's endpoint, tests, chip_smoke)
# ---------------------------------------------------------------------------

DEFAULT_LEDGER_WITNESS: Optional[LedgerWitness] = None


def install_ledger_witness(
    paths: Optional[List[str]] = None,
) -> LedgerWitness:
    """Build the static site map from the real tree and install a
    process-wide witness.  Idempotent; returns the active witness."""
    global DEFAULT_LEDGER_WITNESS
    if DEFAULT_LEDGER_WITNESS is not None:
        return DEFAULT_LEDGER_WITNESS
    DEFAULT_LEDGER_WITNESS = LedgerWitness(
        site_map=build_site_map(paths)
    ).install()
    return DEFAULT_LEDGER_WITNESS


def ledger_snapshot() -> Optional[Dict[str, Any]]:
    """The active witness's dump (None when no witness is installed)."""
    if DEFAULT_LEDGER_WITNESS is None:
        return None
    return DEFAULT_LEDGER_WITNESS.snapshot()


def maybe_install_from_env() -> Optional[LedgerWitness]:
    """``DOCQA_LEDGER_WITNESS=1`` installs the witness at service boot —
    ``GET /api/ledger`` then serves the live dump."""
    if os.environ.get("DOCQA_LEDGER_WITNESS", "") in ("1", "true", "yes"):
        return install_ledger_witness()
    return None
