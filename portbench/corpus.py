"""The 14-file stand-in for the Calgary corpus, frozen for the benchmark.

A copy of the generators of the program's `core/corpus.py` (English-like
text, program sources, structured records, a bitmap, correlated samples,
Markov binary, noise), so that the benchmark's inputs stay the same whatever
a later change does to the program.  The corpus depends on no run's seed;
it takes some seconds of host time to generate, so `corpus()` keeps it in a
file under the checkout's ``build/portbench/cache/`` and reads it back on
later runs.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

CORPUS_SEED = 20240325

_WORDS = (
    "the of and a to in is was he for it with as his on be at by i this had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much your "
    "way well down should because each just those people mr how too little "
    "state good very make world still own see men work long get here between "
    "both life being under never day same another know while last might us "
    "great old year off come since against go came right used take three"
).split()

_C_KEYWORDS = (
    "int", "char", "float", "double", "void", "return", "if", "else", "for",
    "while", "struct", "static", "const", "unsigned", "long", "switch",
    "case", "break", "continue", "sizeof", "typedef", "enum", "extern",
)


def _text_like(rng: np.random.Generator, size: int) -> bytes:
    """Zipf-weighted English-like prose with sentence/paragraph structure."""
    ranks = np.arange(1, len(_WORDS) + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    out = []
    total = 0
    sentence_len = 0
    while total < size:
        w = _WORDS[rng.choice(len(_WORDS), p=probs)]
        if sentence_len == 0:
            w = w.capitalize()
        out.append(w)
        total += len(w) + 1
        sentence_len += 1
        if sentence_len >= rng.integers(6, 18):
            out[-1] += "." if rng.random() < 0.8 else "?"
            sentence_len = 0
            if rng.random() < 0.12:
                out[-1] += "\n\n"
    return (" ".join(out)[:size]).encode("latin-1")


def _code_like(rng: np.random.Generator, size: int) -> bytes:
    """C-like source: repeated identifiers, indentation, boilerplate."""
    idents = [f"var_{i}" for i in range(40)] + [f"fn_{i}" for i in range(20)]
    lines = []
    total = 0
    while total < size:
        kind = rng.random()
        if kind < 0.25:
            ln = f"{rng.choice(_C_KEYWORDS)} {rng.choice(idents)} = {rng.integers(0, 1000)};"
        elif kind < 0.5:
            ln = f"    {rng.choice(idents)} = {rng.choice(idents)} + {rng.choice(idents)};"
        elif kind < 0.7:
            ln = f"if ({rng.choice(idents)} > {rng.integers(0, 100)}) {{"
        elif kind < 0.85:
            ln = f"    return {rng.choice(idents)};"
        else:
            ln = "}"
        lines.append(ln)
        total += len(ln) + 1
    return ("\n".join(lines)[:size]).encode("latin-1")


def _records_like(rng: np.random.Generator, size: int) -> bytes:
    """bib/trans-like structured records with repeated field tags."""
    fields = ["%A ", "%T ", "%J ", "%D ", "%V ", "%P ", "%I "]
    out = []
    total = 0
    rec = 0
    while total < size:
        rec += 1
        for f in fields:
            words = " ".join(rng.choice(_WORDS, size=rng.integers(2, 7)))
            ln = f + words.title()
            out.append(ln)
            total += len(ln) + 1
        out.append("")
        total += 1
    return ("\n".join(out)[:size]).encode("latin-1")


def _bitmap_like(rng: np.random.Generator, size: int) -> bytes:
    """pic-like: long runs of 0x00 with occasional strokes."""
    buf = np.zeros(size, dtype=np.uint8)
    n_strokes = size // 200
    starts = rng.integers(0, size, n_strokes)
    lens = rng.integers(1, 24, n_strokes)
    vals = rng.integers(1, 256, n_strokes)
    for s, l, v in zip(starts, lens, vals):
        buf[s : s + l] = v
    return buf.tobytes()


def _geo_like(rng: np.random.Generator, size: int) -> bytes:
    """geo-like: correlated 32-bit samples (smooth seismic-ish signal)."""
    n = size // 4 + 1
    steps = rng.normal(0, 80.0, n)
    sig = np.cumsum(steps).astype(np.int32)
    return sig.tobytes()[:size]


def _markov_binary(rng: np.random.Generator, size: int, alphabet: int = 64) -> bytes:
    """obj-like: byte stream from a skewed Markov chain (moderate entropy)."""
    trans = rng.dirichlet(np.full(alphabet, 0.06), size=alphabet)
    cum = np.cumsum(trans, axis=1)
    out = np.empty(size, dtype=np.uint8)
    state = 0
    u = rng.random(size)
    for i in range(size):
        state = int(np.searchsorted(cum[state], u[i]))
        out[i] = state
    return out.tobytes()


def _random_bytes(rng: np.random.Generator, size: int) -> bytes:
    """Nearly incompressible."""
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


_SPEC = [
    # (name, generator, size)  — sizes chosen so the full corpus is ~1.2 MB,
    # keeping golden-model sweeps tractable on one CPU core.
    ("bib", _records_like, 108 * 1024),
    ("book1", _text_like, 196 * 1024),
    ("book2", _text_like, 152 * 1024),
    ("geo", _geo_like, 102 * 1024),
    ("news", _text_like, 120 * 1024),
    ("obj1", _markov_binary, 21 * 1024),
    ("obj2", _markov_binary, 96 * 1024),
    ("paper1", _text_like, 53 * 1024),
    ("paper2", _text_like, 82 * 1024),
    ("pic", _bitmap_like, 160 * 1024),
    ("progc", _code_like, 39 * 1024),
    ("progl", _code_like, 71 * 1024),
    ("progp", _code_like, 49 * 1024),
    ("trans", _records_like, 93 * 1024),
]


def generate() -> bytes:
    """The corpus, generated: the 14 files concatenated in their order."""
    files = []
    for i, (name, gen, size) in enumerate(_SPEC):
        rng = np.random.Generator(np.random.PCG64(CORPUS_SEED + i * 1009))
        data = gen(rng, size)
        if len(data) != size:
            raise RuntimeError(f"corpus file {name}: {len(data)} bytes, want {size}")
        files.append(data)
    return b"".join(files)


def corpus(cache_dir: Path) -> bytes:
    """The corpus, from ``cache_dir`` when a file there holds it."""
    tag = hashlib.sha256(Path(__file__).read_bytes()).hexdigest()[:16]
    path = Path(cache_dir) / f"corpus-{tag}.bin"
    digest = path.with_suffix(".sha256")
    if path.is_file() and digest.is_file():
        data = path.read_bytes()
        if hashlib.sha256(data).hexdigest() == digest.read_text().strip():
            return data
    data = generate()
    path.parent.mkdir(parents=True, exist_ok=True)
    for target, content in ((path, data),
                            (digest, hashlib.sha256(data).hexdigest().encode())):
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        tmp.write_bytes(content)
        os.replace(tmp, target)
    return data
