"""Fortran-namelist reader.

The port's own copy of `blom_tpu/core/namelist.py`: parses BLOM's
`limits` run-configuration decks (mod_rdlim.F90 reads the groups LIMITS,
VCOORD, ALE_REGRID_REMAP, DIFFUSION, MERDIA, SECDIA and DIAPHY from a
namelist file).  Pure Python, host side only."""

from __future__ import annotations

import re
from typing import Any, Dict


def _convert_token(tok: str) -> Any:
    t = tok.strip()
    if not t:
        return None
    if (t[0] == "'" and t[-1] == "'") or (t[0] == '"' and t[-1] == '"'):
        return t[1:-1]
    low = t.lower()
    if low in ('.true.', 't', '.t.'):
        return True
    if low in ('.false.', 'f', '.f.'):
        return False
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t.replace('d', 'e').replace('D', 'E'))
    except ValueError:
        pass
    return t


def _split_values(s: str):
    """Split a namelist value string on commas, respecting quotes."""
    out, cur, q = [], [], None
    for ch in s:
        if q:
            cur.append(ch)
            if ch == q:
                q = None
        elif ch in ("'", '"'):
            q = ch
            cur.append(ch)
        elif ch == ',':
            out.append(''.join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur and ''.join(cur).strip():
        out.append(''.join(cur))
    return [v for v in (x.strip() for x in out) if v]


def parse_namelists(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse all `&GROUP ... /` blocks into {group: {key: value}} dicts.

    Scalars stay scalars; comma/space separated lists become Python lists.
    Fortran `n*value` repetition is expanded."""
    groups: Dict[str, Dict[str, Any]] = {}
    # Strip comment lines (leading '!') and inline comments after values.
    lines = []
    for ln in text.splitlines():
        stripped = ln.strip()
        if stripped.startswith('!'):
            continue
        # remove inline comments (only when ! is outside quotes)
        q = None
        cut = len(ln)
        for i, ch in enumerate(ln):
            if q:
                if ch == q:
                    q = None
            elif ch in ("'", '"'):
                q = ch
            elif ch == '!':
                cut = i
                break
        lines.append(ln[:cut])
    text = '\n'.join(lines)

    for m in re.finditer(r'&(\w+)(.*?)(?:^\s*/\s*$|/\s*(?=\n\s*(?:&|\Z))|/\s*\Z)',
                         text, re.S | re.M):
        gname = m.group(1).upper()
        body = m.group(2)
        entries: Dict[str, Any] = {}
        # split into key = value... segments
        parts = re.split(r'(\w+(?:\(\d+\))?)\s*=', body)
        # parts[0] is leading whitespace; then alternating key, value
        for k, v in zip(parts[1::2], parts[2::2]):
            vals = []
            for tok in _split_values(v.replace('\n', ' ')):
                rep = re.match(r'^(\d+)\*(.+)$', tok)
                if rep:
                    vals.extend([_convert_token(rep.group(2))] * int(rep.group(1)))
                else:
                    vals.append(_convert_token(tok))
            entries[k.upper()] = vals[0] if len(vals) == 1 else vals
        groups[gname] = entries
    return groups


def read_namelist_file(path: str) -> Dict[str, Dict[str, Any]]:
    with open(path) as f:
        return parse_namelists(f.read())
