"""Minimal standards-compliant FITS writer/reader (pure Python + NumPy).

The package carries its own FITS layer (no astropy dependency). The format is simple: 2880-byte header blocks of 80-character
keyword cards, then big-endian data padded to 2880 bytes. This module
implements exactly what WFC3 ``ima``-style products need — a data-less
primary HDU plus IMAGE extensions with BITPIX -32 / 16 / 32 — and a reader
for round-trip tests and downstream tooling.

The byte layout is identical to the JAX package's writer, so products of
the two packages are interchangeable. The native C++ writer
(wayne_tpu_torch/native, :mod:`wayne_tpu_torch.io.native`) assembles the
same layout for ima products from headers this module renders.
"""

from __future__ import annotations

import re
import warnings
from dataclasses import dataclass, field
from typing import Any

import numpy as np

BLOCK = 2880
CARD = 80

# Keyword-path shape a HIERARCH-style card's name may take (uppercase
# tokens of keyword characters separated by spaces, the ESO convention).
# The reader's fallback branch uses this to tell a genuine long-keyword
# card from a free-text vendor annotation that merely CONTAINS '=' —
# parsing the latter would pollute copied headers with junk keys.
_HIER_NAME_RE = re.compile(r"[A-Z0-9_.\-]+(?:\s+[A-Z0-9_.\-]+)*")

_BITPIX = {np.dtype(">i2"): 16, np.dtype(">i4"): 32, np.dtype(">f4"): -32,
           np.dtype(">f8"): -64, np.dtype(">i8"): 64}
_DTYPES = {16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8", 8: "u1", 64: ">i8"}


def _fmt_value(value: Any) -> str:
    if isinstance(value, bool):
        return "T" if value else "F"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        s = f"{float(value):.12G}"
        if "." not in s and "E" not in s and "N" not in s:
            s += "."
        return s
    # header cards are ASCII by definition; replace anything else rather
    # than raising mid-visit-write on e.g. a unicode target name
    s = str(value).encode("ascii", "replace").decode("ascii")
    s = s.replace("'", "''")
    return f"'{s:<8s}'"


def card(key: str, value: Any = None, comment: str = "") -> bytes:
    """Format one 80-byte header card.

    Keys beginning ``"HIERARCH "`` (the reader's storage form for ESO
    long keywords) round-trip in the HIERARCH convention
    (``HIERARCH A B C = value``) instead of being truncated to 8
    characters — copying a foreign header into a derived product must
    not collapse every long keyword into one mangled card.
    """
    if key.upper().startswith("HIERARCH "):
        name = key[len("HIERARCH "):].strip()
        v = _fmt_value(value)
        body = f"HIERARCH {name} = {v}"
        if comment and len(body) + 3 + len(comment) <= 80:
            body += f" / {comment}"
        if len(body) > 80:
            # Never silently lose value bytes off the card end: shrink a
            # STRING value (syntax-preserving, like the 8-char-key path
            # above) with a warning; a card that still overflows has a
            # keyword name too long to represent — error, don't corrupt.
            if v.startswith("'"):
                room = 80 - (len(f"HIERARCH {name} = ") + 2)
                inner = v[1:-1][:max(room, 0)]
                if inner.count("'") % 2:      # never split an escaped ''
                    inner = inner[:-1]
                body = f"HIERARCH {name} = '{inner}'"
                warnings.warn(
                    f"HIERARCH card {name!r}: string value truncated to "
                    "fit the 80-byte card", stacklevel=2)
            if len(body) > 80:
                raise ValueError(
                    f"HIERARCH keyword {name!r} + value do not fit an "
                    f"80-byte card ({len(body)} bytes)")
        return f"{body:<80s}".encode("ascii")
    key = key.upper()[:8]
    if value is None and not comment:
        return f"{key:<80s}".encode("ascii")
    if key in ("COMMENT", "HISTORY", ""):
        return f"{key:<8s}{str(value or comment):<72s}"[:80].encode("ascii")
    v = _fmt_value(value)
    if v.startswith("'") and len(v) > 70:
        # Truncate the VALUE, never the syntax: a blind [:80] on the
        # body would cut the closing quote and corrupt the card (the
        # reader would swallow the rest of the card as the value).
        inner = v[1:-1][:67]
        if inner.count("'") % 2:          # never split an escaped ''
            inner = inner[:-1]
        v = f"'{inner}'"
    if v.startswith("'"):
        body = f"{key:<8s}= {v}"
    else:
        body = f"{key:<8s}= {v:>20s}"
    if comment:
        body += f" / {comment}"
    return f"{body:<80s}"[:80].encode("ascii")


def _pad(b: bytes, fill: bytes = b" ") -> bytes:
    rem = (-len(b)) % BLOCK
    return b + fill * rem


@dataclass
class FitsHDU:
    """One HDU: ordered header cards + optional image data."""

    name: str = ""
    ver: int = 1
    data: np.ndarray | None = None
    header: dict[str, Any] = field(default_factory=dict)
    comments: dict[str, str] = field(default_factory=dict)

    def to_bytes(self, primary: bool) -> bytes:
        cards: list[bytes] = []
        data = self.data
        scale_cards: list[bytes] = []
        if data is not None:
            data = np.ascontiguousarray(data)
            # FITS has no unsigned BITPIX: write u2/u4 the standard way
            # (signed storage + BZERO offset), so arrays the READER
            # returned for BZERO-convention files round-trip instead of
            # raising KeyError on the unsigned dtype.
            if data.dtype == np.uint16:
                data = (data.astype(np.int32) - 32768).astype(np.int16)
                scale_cards = [card("BSCALE", 1),
                               card("BZERO", 32768,
                                    "unsigned 16-bit convention")]
            elif data.dtype == np.uint32:
                data = (data.astype(np.int64)
                        - 2147483648).astype(np.int32)
                scale_cards = [card("BSCALE", 1),
                               card("BZERO", 2147483648,
                                    "unsigned 32-bit convention")]
            be = data.dtype.newbyteorder(">")
            data = data.astype(be, copy=False)
            bitpix = _BITPIX[np.dtype(be)]
        if primary:
            cards.append(card("SIMPLE", True, "conforms to FITS standard"))
            cards.append(card("BITPIX", bitpix if data is not None else 8))
            cards.append(card("NAXIS", 0 if data is None else data.ndim))
        else:
            cards.append(card("XTENSION", "IMAGE", "image extension"))
            cards.append(card("BITPIX", bitpix if data is not None else 8))
            cards.append(card("NAXIS", 0 if data is None else data.ndim))
        if data is not None:
            for i, n in enumerate(reversed(data.shape)):
                cards.append(card(f"NAXIS{i + 1}", int(n)))
        if not primary:
            cards.append(card("PCOUNT", 0))
            cards.append(card("GCOUNT", 1))
            if self.name:
                cards.append(card("EXTNAME", self.name))
                cards.append(card("EXTVER", self.ver))
        else:
            cards.append(card("EXTEND", True, "file contains extensions"))
            if self.name:
                cards.append(card("EXTNAME", self.name))
        cards.extend(scale_cards)
        for key, value in self.header.items():
            if scale_cards and key in ("BSCALE", "BZERO"):
                continue        # the data-derived convention wins
            cards.append(card(key, value, self.comments.get(key, "")))
        cards.append(card("END"))
        out = _pad(b"".join(cards))
        if data is not None:
            # the FITS standard zero-fills DATA blocks (headers are
            # space-filled) — space padding here trips strict validators
            out += _pad(data.tobytes(), fill=b"\0")
        return out


def header_only_bytes(*, primary: bool, name: str = "", ver: int = 1,
                      shape: tuple[int, ...] = (), bitpix: int = -32,
                      header: dict[str, Any] | None = None) -> bytes:
    """Render just the (padded) header block for an HDU of known shape,
    for the native writer, which streams the data section itself."""
    cards: list[bytes] = []
    if primary:
        cards.append(card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(card("XTENSION", "IMAGE", "image extension"))
    cards.append(card("BITPIX", bitpix if shape else 8))
    cards.append(card("NAXIS", len(shape)))
    for i, n in enumerate(reversed(shape)):
        cards.append(card(f"NAXIS{i + 1}", int(n)))
    if not primary:
        cards.append(card("PCOUNT", 0))
        cards.append(card("GCOUNT", 1))
        if name:
            cards.append(card("EXTNAME", name))
            cards.append(card("EXTVER", ver))
    else:
        cards.append(card("EXTEND", True, "file contains extensions"))
    for key, value in (header or {}).items():
        cards.append(card(key, value))
    cards.append(card("END"))
    return _pad(b"".join(cards))


def write_fits(path: str, hdus: list[FitsHDU]) -> None:
    """Write HDUs to ``path`` (first HDU is primary)."""
    with open(path, "wb") as fh:
        for i, hdu in enumerate(hdus):
            fh.write(hdu.to_bytes(primary=(i == 0)))


def _parse_string(body: str) -> tuple[str, bool]:
    """Parse a quoted FITS string value. Returns (value, had_ampersand)
    with the OGIP long-string continuation ampersand stripped (the
    caller decides whether a CONTINUE card actually follows)."""
    s = body.lstrip()[1:]
    # FITS escapes a quote inside a string as '' — scan for the
    # first single (unpaired) closing quote.
    out = []
    j = 0
    while j < len(s):
        if s[j] == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            break
        out.append(s[j])
        j += 1
    v = "".join(out).rstrip()
    if v.endswith("&"):
        return v[:-1], True
    return v, False


def _parse_value(body: str) -> tuple[Any, bool]:
    """Parse a card's value body -> (value, string_continues)."""
    if body.lstrip().startswith("'"):
        return _parse_string(body)
    v = body.split("/")[0].strip()
    if v == "T":
        return True, False
    if v == "F":
        return False, False
    try:
        return int(v), False
    except ValueError:
        pass
    try:
        return float(v), False
    except ValueError:
        return v, False


def _parse_header(raw: bytes, start: int = 0) -> tuple[dict[str, Any], int]:
    """Parse header cards from ``raw`` at ``start``; returns
    (header, bytes consumed). Takes the whole buffer plus an offset so
    callers never slice-copy the remaining file per HDU (a 64 MB ima
    has ~80 HDUs — tail copies made reads O(N^2)).

    Tolerates the quirks real MAST/astropy products carry beyond what
    this module writes (support matrix in docs/API.md):

    - blank cards anywhere, including before END, and non-standard
      NUL-padded header blocks (NULs treated as spaces);
    - OGIP long-string values: a string ending in ``&`` is continued by
      following ``CONTINUE`` cards, joined transparently;
    - ESO ``HIERARCH`` cards (``HIERARCH A B C = v``), stored under the
      full ``"HIERARCH A B C"`` key;
    - COMMENT/HISTORY cards are skipped (they carry no value syntax).
    """
    header: dict[str, Any] = {}
    pos = start
    last_string_key: str | None = None

    def flush_amp():
        # A string ended in '&' but the NEXT card is not CONTINUE: per
        # OGIP the '&' is only a continuation marker when a CONTINUE
        # card actually follows — otherwise it is literal data and must
        # be restored (values like 'F160W&' would otherwise silently
        # lose their last character).
        nonlocal last_string_key
        if last_string_key is not None:
            header[last_string_key] += "&"
            last_string_key = None

    while True:
        block = raw[pos: pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        pos += BLOCK
        done = False
        for i in range(0, BLOCK, CARD):
            c = block[i: i + CARD].decode("ascii", errors="replace")
            c = c.replace("\x00", " ")       # NUL-padded header blocks
            key = c[:8].strip()
            if key != "CONTINUE":
                flush_amp()
            if key == "END":
                done = True
                break
            if key == "CONTINUE":
                # OGIP long-string continuation: append to the pending
                # string value (only strings can continue).
                if last_string_key is not None:
                    more, cont = _parse_string(c[8:])
                    header[last_string_key] += more
                    if not cont:
                        last_string_key = None
                continue
            if key == "HIERARCH" or (key and c[8:10] != "= "
                                     and "=" in c and key not in
                                     ("COMMENT", "HISTORY")):
                # ESO HIERARCH convention: keyword tokens up to the
                # first '=', value after it.
                body = c[8:] if key == "HIERARCH" else c
                name, _, rest = body.partition("=")
                name = name.strip()
                if not name or not rest.strip():
                    continue
                if (key != "HIERARCH"
                        and not _HIER_NAME_RE.fullmatch(name)):
                    # free-text annotation card that merely contains
                    # '=' (vendor comments, lowercase prose): not a
                    # key=value card — skip rather than invent a key
                    continue
                full = (f"HIERARCH {name}" if key == "HIERARCH"
                        else name)
                value, cont = _parse_value(rest)
                header[full] = value
                last_string_key = full if cont else None
                continue
            if not key or c[8:10] != "= ":
                continue
            value, cont = _parse_value(c[10:])
            header[key] = value
            last_string_key = key if cont else None
        if done:
            break
    return header, pos - start


def read_fits(path: str) -> list[tuple[dict[str, Any], np.ndarray | None]]:
    """Read all HDUs: list of (header, data) with data in native byte order.

    Hardened for foreign (MAST/astropy-written) files, not just this
    module's own output:

    - **BSCALE/BZERO** scaling is APPLIED: stored integers come back as
      physical values (``BSCALE*stored + BZERO``). The common unsigned
      conventions (BITPIX 16 / BZERO 32768, BITPIX 32 / BZERO 2^31)
      return exact unsigned integer arrays; anything else returns
      float64. The scaling keys are reset to identity in the returned
      header so downstream consumers never double-apply them.
    - **Table extensions** (BINTABLE/TABLE, e.g. the association or
      catalog HDUs real products append) are SKIPPED — their header is
      returned with ``data=None`` and the data section, including the
      PCOUNT heap, is stepped over so subsequent image HDUs stay
      aligned. Tile-compressed images (fpack ZIMAGE BINTABLEs) are
      therefore also skipped, not decompressed — run funpack first.
    - The data-section size follows the standard formula
      ``|BITPIX|/8 * GCOUNT * (PCOUNT + prod(NAXIS*))``.
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    out: list[tuple[dict[str, Any], np.ndarray | None]] = []
    pos = 0
    while pos < len(raw):
        header, used = _parse_header(raw, pos)
        pos += used
        naxis = int(header.get("NAXIS", 0))
        xtension = str(header.get("XTENSION", "")).strip().upper()
        is_table = xtension in ("BINTABLE", "TABLE", "A3DTABLE")
        data = None
        if naxis > 0:
            shape = tuple(int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
            bitpix = int(header["BITPIX"])
            itemsize = abs(bitpix) // 8
            count = int(np.prod(shape))
            pcount = int(header.get("PCOUNT", 0))
            gcount = int(header.get("GCOUNT", 1))
            nbytes = itemsize * gcount * (pcount + count)
            if not is_table and count > 0:
                dtype = np.dtype(_DTYPES[bitpix])
                data = np.frombuffer(raw, dtype=dtype, count=count,
                                     offset=pos).reshape(shape)
                data = data.astype(data.dtype.newbyteorder("="))
                bscale = header.get("BSCALE", 1)
                bzero = header.get("BZERO", 0)
                if (bscale, bzero) != (1, 0):
                    if bitpix == 16 and bscale == 1 and bzero == 32768:
                        data = (data.astype(np.int32) + 32768
                                ).astype(np.uint16)
                    elif bitpix == 32 and bscale == 1 and bzero == 2**31:
                        data = (data.astype(np.int64) + 2**31
                                ).astype(np.uint32)
                    else:
                        data = (np.float64(bscale) * data
                                + np.float64(bzero))
                    header["BSCALE"], header["BZERO"] = 1, 0
            pos += nbytes + ((-nbytes) % BLOCK)
        out.append((header, data))
    return out
