"""Text extraction (host-side stage), counterpart of
``docqa_tpu/service/extract.py`` — verbatim except the HTTP escape hatch,
which uses the standard library's ``urllib.request`` where the reference
imports ``httpx`` (same PUT, headers and timeout).

Replaces the reference's external Apache Tika JVM server
(``doc-ingestor/processing.py:10-19``, ``docker-compose.yml:34-38``) with
in-process pure-Python extractors for the three formats the reference UI
accepts — pdf / txt / docx (``clinical-ui/app.py:38``) — plus the same
HTTP-server escape hatch for anything exotic.

Contract mirrors ``extract_text_from_file``: returns the stripped text, or
``None`` on failure (``processing.py:16-19``).
"""

from __future__ import annotations

import io
import re
import urllib.request
import zipfile
import zlib
from typing import Callable, Dict, Optional, Tuple

from docqa_tpu_torch.runtime.metrics import DEFAULT_REGISTRY, get_logger

log = get_logger("docqa.extract")


# ---- plain text ------------------------------------------------------------

def extract_txt(data: bytes) -> Optional[str]:
    for enc in ("utf-8", "utf-16", "latin-1"):
        try:
            text = data.decode(enc).strip()
        except (UnicodeDecodeError, UnicodeError):
            continue
        # latin-1 decodes ANY byte string — reject binary mojibake so the
        # HTTP (Tika) fallback stays reachable for real binary formats
        if text and _control_fraction(text) > 0.05:
            return None
        return text
    return None


def _control_fraction(text: str) -> float:
    n = len(text)
    if n == 0:
        return 0.0
    bad = sum(
        1
        for c in text
        if (ord(c) < 32 and c not in "\n\r\t") or 0x7F <= ord(c) < 0xA0
    )
    return bad / n


# ---- docx ------------------------------------------------------------------

_DOCX_TAG_RE = re.compile(rb"<[^>]+>")


def extract_docx(data: bytes) -> Optional[str]:
    """DOCX = zip; text lives in word/document.xml.  Paragraph tags become
    newlines, every other tag is stripped."""
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            xml = z.read("word/document.xml")
    except (zipfile.BadZipFile, KeyError):
        return None
    xml = re.sub(rb"</w:p>", b"\n", xml)
    xml = re.sub(rb"<w:tab[^>]*/>", b"\t", xml)
    text = _DOCX_TAG_RE.sub(b"", xml).decode("utf-8", errors="replace")
    # unescape the XML entities that matter in prose
    for ent, ch in (
        ("&amp;", "&"), ("&lt;", "<"), ("&gt;", ">"),
        ("&quot;", '"'), ("&apos;", "'"),
    ):
        text = text.replace(ent, ch)
    return text.strip() or None


# ---- pdf -------------------------------------------------------------------

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
_TEXT_OP_RE = re.compile(
    rb"\((?:[^()\\]|\\.)*\)\s*Tj"  # (string) Tj
    rb"|\[(?:[^\]\\]|\\.)*\]\s*TJ"  # [ (s) kern (s) ] TJ
    rb"|T\*|TD|Td",  # line-advance operators → newline
)
_PDF_STR_RE = re.compile(rb"\((?:[^()\\]|\\.)*\)")

_PDF_ESCAPES = {
    ord("n"): b"\n", ord("r"): b"\r", ord("t"): b"\t",
    ord("b"): b"\b", ord("f"): b"\f",
    ord("("): b"(", ord(")"): b")", ord("\\"): b"\\",
}


def _decode_pdf_string(raw: bytes) -> bytes:
    """PDF literal-string unescape via a single left-to-right scan (sequential
    ``replace`` calls mis-decode sequences like ``\\\\n`` — an escaped
    backslash followed by a literal 'n' — because a later pattern can consume
    the output of an earlier one)."""
    src = raw[1:-1]  # strip parens
    out = bytearray()
    i = 0
    while i < len(src):
        c = src[i]
        if c != 0x5C:  # backslash
            out.append(c)
            i += 1
            continue
        if i + 1 >= len(src):
            break
        nxt = src[i + 1]
        if nxt in _PDF_ESCAPES:
            out += _PDF_ESCAPES[nxt]
            i += 2
        elif 0x30 <= nxt <= 0x37:  # \ddd octal, 1-3 digits
            j = i + 1
            while j < min(i + 4, len(src)) and 0x30 <= src[j] <= 0x37:
                j += 1
            out.append(int(src[i + 1 : j], 8) & 0xFF)
            i = j
        elif nxt in (0x0A, 0x0D):  # line continuation: \<eol> is elided
            i += 2
            if nxt == 0x0D and i < len(src) and src[i] == 0x0A:
                i += 1
        else:  # unknown escape: PDF spec says drop the backslash
            out.append(nxt)
            i += 2
    return bytes(out)


def _iter_streams(data: bytes):
    """Yield ``(dict_window, content)`` per PDF stream: the bytes of the
    object dictionary immediately preceding the ``stream`` keyword and
    the inflated (or raw, for uncompressed streams) body — the ONE
    stream walk shared by :func:`extract_pdf` and the failure diagnosis
    (`_pdf_has_text_content`), so stream handling cannot drift between
    extraction and its post-mortem."""
    for m in _STREAM_RE.finditer(data):
        raw = m.group(1)
        try:
            content = zlib.decompress(raw)
        except zlib.error:
            content = raw  # uncompressed stream
        # the dict window stops at the nearest object boundary so one
        # stream's window can never swallow the PREVIOUS object's dict
        # (tiny PDFs put several objects within 300 bytes)
        start = m.start()
        head_start = max(
            data.rfind(b"obj", 0, start),
            data.rfind(b"endstream", 0, start),
            start - 300,
            0,
        )
        yield data[head_start:start], content


def extract_pdf(data: bytes) -> Optional[str]:
    """Minimal PDF text extraction: inflate content streams, read Tj/TJ
    show-text operators.  Covers linear text PDFs (clinical letters/reports);
    image-only or CID-encoded PDFs fall through to the HTTP extractor if one
    is configured."""
    if not data.startswith(b"%PDF"):
        return None
    pieces = []
    for _head, content in _iter_streams(data):
        if b"Tj" not in content and b"TJ" not in content:
            continue
        line: list = []
        for op in _TEXT_OP_RE.finditer(content):
            tok = op.group()
            if tok in (b"T*", b"TD", b"Td") or tok.endswith((b"TD", b"Td")):
                if line:
                    pieces.append(b"".join(line))
                    line = []
                continue
            for s in _PDF_STR_RE.finditer(tok):
                line.append(_decode_pdf_string(s.group()))
        if line:
            pieces.append(b"".join(line))
    if not pieces:
        return None
    text = b"\n".join(pieces).decode("utf-8", errors="replace").strip()
    return text or None


# ---- HTTP escape hatch (Tika-protocol compatible) --------------------------

def make_http_extractor(server_url: str) -> Callable[[bytes], Optional[str]]:
    """PUT bytes to a Tika-compatible server (`{server}/tika`) — the same
    wire protocol the reference used (``processing.py:15``), kept as an
    opt-in fallback for scanned/exotic formats."""

    def extract(data: bytes) -> Optional[str]:
        try:
            req = urllib.request.Request(
                f"{server_url.rstrip('/')}/tika",
                data=data,
                headers={"Accept": "text/plain"},
                method="PUT",
            )
            # urlopen raises HTTPError on a 4xx/5xx status
            with urllib.request.urlopen(req, timeout=30.0) as r:
                charset = r.headers.get_content_charset() or "utf-8"
                text = r.read().decode(charset, errors="replace")
            return text.strip() or None
        except Exception:
            log.exception("http extraction failed")
            return None

    return extract


# ---- failure diagnosis -----------------------------------------------------

# PDF filters the in-process extractor cannot decode (only FlateDecode and
# raw streams are); their presence explains a text-less extraction
_PDF_HARD_FILTERS = (
    b"LZWDecode", b"CCITTFaxDecode", b"JBIG2Decode", b"RunLengthDecode",
    b"ASCII85Decode", b"ASCIIHexDecode",
)
_PDF_IMAGE_MARKS = (b"DCTDecode", b"JPXDecode", b"/Image")

# Evidence that a PDF carries TEXT content even though extraction came
# back empty: structured show-text operators inside a (decompressable)
# content stream — literal, hex (CID-keyed fonts), or array form — or
# font-machinery dictionaries (/ToUnicode, /CIDFont).  Deliberately
# structural patterns, not bare "Tj"/"BT" substrings: JPEG payloads
# contain arbitrary byte pairs and must not read as text evidence.
_PDF_TEXT_EVIDENCE_RE = re.compile(
    rb"\((?:[^()\\]|\\.)*\)\s*T[jJ]"
    rb"|<[0-9A-Fa-f\s]+>\s*T[jJ]"
    rb"|\[(?:[^\]\\]|\\.)*\]\s*TJ"
)


def _pdf_has_text_content(data: bytes) -> bool:
    if b"/ToUnicode" in data or b"/CIDFont" in data:
        return True
    for head, content in _iter_streams(data):
        # image streams are raw compressed pixel data — multi-MB JPEG
        # bodies can coincidentally contain show-text-shaped byte runs,
        # and a false "text evidence" hit would steer a genuinely
        # scanned PDF's operator away from OCR
        if any(mark in head for mark in _PDF_IMAGE_MARKS):
            continue
        if _PDF_TEXT_EVIDENCE_RE.search(content):
            return True
    return False

# THE signature table: known non-plain-text containers with no in-process
# extractor, (magic prefixes, diagnosis slug).  Read by BOTH the dispatch
# gate in extract_text_ex (so these never fall into the latin-1 text
# sniffer) and diagnose_unextractable (so the failure reason names the
# format) — one list, no drift.
_BINARY_SIGNATURES = (
    ((b"{\\rtf",), "rtf_document"),
    ((b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1",), "legacy_ole2_document"),
    (
        (b"\xff\xd8\xff", b"\x89PNG\r\n\x1a\n", b"GIF8", b"II*\x00",
         b"MM\x00*"),
        "image_file",
    ),
)


def _signature_slug(data: bytes) -> Optional[str]:
    for prefixes, slug in _BINARY_SIGNATURES:
        if data.startswith(prefixes):
            return slug
    return None


def diagnose_unextractable(data: bytes, filename: str) -> str:
    """Classify WHY extraction produced no text — an actionable reason
    slug recorded as the registry row's ``status_detail`` (VERDICT r4
    item 7: a scanned-PDF upload must produce a precise error, not
    undifferentiated ERROR_EXTRACTION noise; the reference shipped every
    format to Tika and could not say why one came back empty,
    ``processing.py:16-19``).

    Slugs (stable API, surfaced by ``GET /documents/``):
      * ``pdf_encrypted``          — /Encrypt dictionary present
      * ``pdf_scanned_image_only`` — image XObjects, no text operators
      * ``pdf_unsupported_filter`` — LZW/CCITT/JBIG2/... streams only
      * ``pdf_no_extractable_text``— PDF without either (CID-keyed fonts)
      * ``legacy_ole2_document``   — .doc/.xls/.ppt (OLE2 container)
      * ``rtf_document``           — RTF source
      * ``image_file``             — bare JPEG/PNG/GIF/TIFF upload
      * ``empty_file``             — zero-length body
      * ``binary_unrecognized``    — none of the above
    Each of these is extractable via the HTTP escape hatch
    (``make_http_extractor`` + the compose ``extractor`` profile), so the
    operator's fix is either "enable the extractor service" or "convert
    before upload" — the detail says which document needs it.
    """
    if not data:
        return "empty_file"
    if data.startswith(b"%PDF"):
        if b"/Encrypt" in data:
            return "pdf_encrypted"
        # Text evidence FIRST: a text PDF with a letterhead logo (or a
        # CID-font report with figures) contains image marks too, and the
        # old image-marks-first order mislabeled every such failure
        # "scanned" — sending the operator to OCR when the actionable fix
        # was the unsupported stream filter or the CID font.
        if any(m in data for m in _PDF_IMAGE_MARKS) and not (
            _pdf_has_text_content(data)
        ):
            return "pdf_scanned_image_only"
        if any(f in data for f in _PDF_HARD_FILTERS):
            return "pdf_unsupported_filter"
        return "pdf_no_extractable_text"
    slug = _signature_slug(data)
    if slug is not None:
        return slug
    return "binary_unrecognized"


# ---- dispatch --------------------------------------------------------------

_BY_EXT: Dict[str, Callable[[bytes], Optional[str]]] = {
    "txt": extract_txt,
    "md": extract_txt,
    "csv": extract_txt,
    "json": extract_txt,
    "docx": extract_docx,
    "pdf": extract_pdf,
}


def extract_text_ex(
    data: bytes,
    filename: str,
    http_fallback: Optional[Callable[[bytes], Optional[str]]] = None,
) -> Tuple[Optional[str], Optional[str]]:
    """Extension-dispatched extraction; content signatures override the
    extension (a ``.txt``-named RTF or OLE2 upload must not index latin-1
    markup noise); anything the in-process extractors cannot read is
    AUTO-ROUTED to the HTTP Tika-protocol escape hatch when one is
    configured (VERDICT item 7: with the ``extractor`` compose profile
    up, scanned PDFs / legacy ``.doc`` / RTF ingest out of the box like
    the reference, instead of dead-ending in ``ERROR_EXTRACTION``).
    Returns ``(text, failure_reason)`` — exactly one side is set."""
    ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
    fn = _BY_EXT.get(ext)
    # Known NON-text container signatures override BOTH the extension
    # table and the text sniffer: RTF source or an OLE2 .doc decodes as
    # latin-1 "text", which would index markup noise instead of routing
    # to the escape hatch with an actionable reason.
    if _signature_slug(data) is not None:
        fn = None  # no in-process extractor; diagnose + escape hatch
    elif fn is None:
        # unknown extension: dispatch on signature
        if data.startswith(b"%PDF"):
            fn = extract_pdf
        elif data[:2] == b"PK":  # zip container: try docx
            fn = extract_docx
        else:
            fn = extract_txt
    text = fn(data) if fn is not None else None
    if text is not None:
        return text, None
    # in-process extraction failed: diagnose WHY, then auto-route the
    # bytes to the Tika-protocol server (the reference's unconditional
    # path, processing.py:15) — the slug tells the operator which
    # format needed the escape hatch whether or not it rescued the doc
    reason = diagnose_unextractable(data, filename)
    if http_fallback is not None:
        log.info(
            "auto-routing %s (%s) to the HTTP extractor", filename, reason
        )
        DEFAULT_REGISTRY.counter("extract_http_routed").inc()
        text = http_fallback(data)
        if text is not None:
            DEFAULT_REGISTRY.counter("extract_http_rescued").inc()
            return text, None
        reason += "_after_http_fallback"
    return None, reason


def extract_text(
    data: bytes,
    filename: str,
    http_fallback: Optional[Callable[[bytes], Optional[str]]] = None,
) -> Optional[str]:
    """Back-compat wrapper over :func:`extract_text_ex` (text only)."""
    return extract_text_ex(data, filename, http_fallback)[0]
