"""Tokenizers with the Whisper special-token contract.

A copy of ``avsl_tpu/data/tokenizer.py`` (the port imports nothing of the
JAX package); ``regex`` and ``transformers`` stay imported lazily.

The reference tokenizes with the Whisper BPE tokenizer plus a custom
``<laugh>`` token (avsl/whisper_flamingo_ft_ami.py:457-467, 259-265 in
the reference repository: SOT sequence ``[sot, <|lang|>, transcribe,
notimestamps]`` + BPE of " " + text; labels are the shifted sequence +
EOT). The BPE merges are never downloaded; the framework defines the
*interface* plus two backends:

* :class:`BPETokenizer` — from-scratch GPT-2-style byte-level BPE (the
  algorithm Whisper's tokenizer uses): byte-to-unicode alphabet, regex
  pre-tokenization, ranked merge loop. Loads a local ``vocab.json`` +
  ``merges.txt`` (never downloads); when the base vocab has GPT-2's 50257
  entries the appended special tokens land on the published Whisper ids.
  Also provides :meth:`BPETokenizer.train` so offline runs can build a
  real subword vocab from their own transcripts.
* :class:`ByteTokenizer` — self-contained byte-level tokenizer (ids 0-255
  are raw bytes) with the standard Whisper special-token ids appended
  above a configurable base. Fully offline; used for tests and
  training-from-scratch runs.
* :class:`HFWhisperTokenizer` — adapter over a locally available
  ``transformers`` WhisperTokenizer (pass a local path; never downloads).

Both expose: encode/decode, ``sot_sequence(lang)``, ``eot``/``sot``/
``transcribe``/``no_timestamps`` ids, ``special_tokens`` mapping,
``add_tokens`` (returns new vocab size for embedding resize), and
``special_token_set`` for decode-time stripping.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

# Published Whisper multilingual special-token ids (for checkpoint parity).
WHISPER_SOT = 50258
WHISPER_EOT = 50257
WHISPER_TRANSLATE = 50358
WHISPER_TRANSCRIBE = 50359
WHISPER_NO_TIMESTAMPS = 50363
WHISPER_LANG_BASE = 50259  # <|en|> is 50259
WHISPER_LANGS = ("en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr")


class Tokenizer:
    """Interface: see module docstring."""

    eot: int
    sot: int
    transcribe: int
    no_timestamps: int
    special_tokens: Dict[str, int]

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    @property
    def special_token_set(self) -> set:
        return set(self.special_tokens.values())

    def sot_sequence(self, lang: str = "en") -> List[int]:
        if f"<|{lang}|>" not in self.special_tokens:
            known = sorted(
                n[2:-2] for n in self.special_tokens
                if n.startswith("<|") and len(n) <= 7
            )
            raise ValueError(
                f"unknown language {lang!r}; this tokenizer knows {known}"
            )
        return [
            self.sot,
            self.special_tokens[f"<|{lang}|>"],
            self.transcribe,
            self.no_timestamps,
        ]

    def prepare_example(self, text: str, lang: str = "en") -> Dict[str, List[int]]:
        """Reference convention: dec_input_ids = SOT seq + encode(" "+text);
        labels = dec_input_ids[1:] + [eot]."""
        dec = self.sot_sequence(lang) + self.encode(" " + text.strip())
        labels = dec[1:] + [self.eot]
        return {"dec_input_ids": dec, "labels": labels}


# Whisper's canonical language ordering (lang token id = 50259 + index when
# the base vocab is GPT-2's 50257; matches openai-whisper tokenizer.py).
WHISPER_ALL_LANGS = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()

# GPT-2 pre-tokenization pattern (same one Whisper uses).
_BPE_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
    r"""|\s+(?!\S)|\s+"""
)


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode alphabet."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer(Tokenizer):
    """From-scratch byte-level BPE with the Whisper special-token layout.

    ``vocab`` maps token string (in byte-unicode alphabet) -> id; ``merges``
    is the ranked list of (left, right) pairs. Special tokens are appended
    above the base vocab in Whisper's canonical order, so with a genuine
    GPT-2/Whisper vocab (50257 entries) every special id matches the
    published values (sot 50258, <|en|> 50259, transcribe 50359, ...).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[tuple],
        langs: Sequence[str] = WHISPER_ALL_LANGS,
    ):
        import regex

        self._pat = regex.compile(_BPE_PATTERN)
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}
        self._vocab = dict(vocab)
        self._inv_vocab = {v: k for k, v in self._vocab.items()}
        self._ranks = {tuple(m): i for i, m in enumerate(merges)}
        self._cache: Dict[str, List[int]] = {}

        nid = max(self._vocab.values()) + 1 if self._vocab else 0
        self.special_tokens: Dict[str, int] = {}
        for name in ("<|endoftext|>", "<|startoftranscript|>"):
            self.special_tokens[name] = nid
            nid += 1
        for lang in langs:
            self.special_tokens[f"<|{lang}|>"] = nid
            nid += 1
        for name in (
            "<|translate|>", "<|transcribe|>", "<|startoflm|>",
            "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>",
        ):
            self.special_tokens[name] = nid
            nid += 1
        self.eot = self.special_tokens["<|endoftext|>"]
        self.sot = self.special_tokens["<|startoftranscript|>"]
        self.translate = self.special_tokens["<|translate|>"]
        self.transcribe = self.special_tokens["<|transcribe|>"]
        self.no_timestamps = self.special_tokens["<|notimestamps|>"]
        self._added: Dict[str, int] = {}
        self._next_id = nid

    # -- construction -----------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw) -> "BPETokenizer":
        """Load a local GPT-2/Whisper ``vocab.json`` + ``merges.txt``."""
        import json

        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw) -> "BPETokenizer":
        import os

        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    @classmethod
    def train(
        cls, texts: Iterable[str], vocab_size: int, **kw
    ) -> "BPETokenizer":
        """Train a BPE vocab offline (standard most-frequent-pair merges
        over the byte-unicode alphabet; deterministic tie-break)."""
        import collections

        import regex

        pat = regex.compile(_BPE_PATTERN)
        byte_enc = bytes_to_unicode()
        words: collections.Counter = collections.Counter()
        for text in texts:
            for piece in pat.findall(text):
                words[
                    tuple(byte_enc[b] for b in piece.encode("utf-8"))
                ] += 1

        vocab = {ch: i for i, ch in enumerate(sorted(byte_enc.values()))}
        merges: List[tuple] = []
        while len(vocab) < vocab_size:
            pairs: collections.Counter = collections.Counter()
            for word, freq in words.items():
                for pair in zip(word, word[1:]):
                    pairs[pair] += freq
            if not pairs:
                break
            best = max(pairs, key=lambda p: (pairs[p], p))
            merges.append(best)
            merged = best[0] + best[1]
            vocab[merged] = len(vocab)
            new_words: collections.Counter = collections.Counter()
            for word, freq in words.items():
                out, i = [], 0
                while i < len(word):
                    if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                        out.append(merged)
                        i += 2
                    else:
                        out.append(word[i])
                        i += 1
                new_words[tuple(out)] += freq
            words = new_words
        return cls(vocab, merges, **kw)

    def save(self, path: str) -> None:
        """Write vocab.json + merges.txt (round-trips via from_dir)."""
        import json
        import os

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self._vocab, f, ensure_ascii=False)
        with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            ordered = sorted(self._ranks, key=self._ranks.get)
            f.writelines(f"{a} {b}\n" for a, b in ordered)

    # -- core BPE ----------------------------------------------------------
    def _bpe(self, piece: str) -> List[int]:
        if piece in self._cache:
            return self._cache[piece]
        word = [self._byte_enc[b] for b in piece.encode("utf-8")]
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self._ranks.get(p, float("inf")))
            if best not in self._ranks:
                break
            merged, out, i = best[0] + best[1], [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        # byte fallback: unknown symbols decompose to single-char entries
        ids: List[int] = []
        for tok in word:
            if tok in self._vocab:
                ids.append(self._vocab[tok])
            else:
                ids.extend(self._vocab[c] for c in tok if c in self._vocab)
        self._cache[piece] = ids
        return ids

    @property
    def vocab_size(self) -> int:
        return self._next_id

    def add_tokens(self, tokens: Iterable[str]) -> int:
        for tok in tokens:
            if tok not in self._added and tok not in self.special_tokens:
                self._added[tok] = self._next_id
                self._next_id += 1
        self._split_cache = None  # new markers invalidate the split pattern
        return self.vocab_size

    def _marker_split(self):
        """(markers, compiled split pattern) — cached; add_tokens
        invalidates. Rebuilding the ~110-alternative pattern per encode()
        call costs a string build + cache lookup for every dataset item
        every epoch."""
        if getattr(self, "_split_cache", None) is None:
            import regex

            markers = {**self._added, **self.special_tokens}
            pat = regex.compile("(" + "|".join(
                regex.escape(n) for n in sorted(markers, key=len, reverse=True)
            ) + ")") if markers else None
            self._split_cache = (markers, pat)
        return self._split_cache

    def encode(self, text: str) -> List[int]:
        markers, pat = self._marker_split()
        chunks = pat.split(text) if pat is not None else [text]
        out: List[int] = []
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in markers:
                out.append(markers[chunk])
                continue
            for piece in self._pat.findall(chunk):
                out.extend(self._bpe(piece))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        rev_added = {v: k for k, v in self._added.items()}
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i in self._inv_vocab:
                parts.append(self._inv_vocab[i])
            elif i in rev_added:
                parts.append(rev_added[i])
            # special tokens are dropped from text output
        buf = "".join(parts)
        data = bytes(self._byte_dec[c] for c in buf if c in self._byte_dec)
        return data.decode("utf-8", errors="replace")


class ByteTokenizer(Tokenizer):
    """Byte-level tokenizer with Whisper-style special tokens.

    ids [0, 256) are raw bytes; special tokens and user tokens follow."""

    def __init__(self, langs: Sequence[str] = WHISPER_ALL_LANGS):
        # full Whisper language set by default — the BPE backend supports
        # all 99, and a byte-fallback run with lang='pl' must not differ
        self._base = 256
        self.special_tokens: Dict[str, int] = {}
        nid = self._base
        for name in ("<|endoftext|>", "<|startoftranscript|>"):
            self.special_tokens[name] = nid
            nid += 1
        for lang in langs:
            self.special_tokens[f"<|{lang}|>"] = nid
            nid += 1
        for name in ("<|translate|>", "<|transcribe|>", "<|notimestamps|>"):
            self.special_tokens[name] = nid
            nid += 1
        self.eot = self.special_tokens["<|endoftext|>"]
        self.sot = self.special_tokens["<|startoftranscript|>"]
        self.translate = self.special_tokens["<|translate|>"]
        self.transcribe = self.special_tokens["<|transcribe|>"]
        self.no_timestamps = self.special_tokens["<|notimestamps|>"]
        self._added: Dict[str, int] = {}
        self._next_id = nid

    @property
    def vocab_size(self) -> int:
        return self._next_id

    def add_tokens(self, tokens: Iterable[str]) -> int:
        """Register user tokens (e.g. ``<laugh>``); returns new vocab size
        (the embedding-resize contract)."""
        for tok in tokens:
            if tok not in self._added and tok not in self.special_tokens:
                self._added[tok] = self._next_id
                self._next_id += 1
        return self.vocab_size

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        i = 0
        # greedy match added/special tokens first (longest token wins)
        markers = {**self._added, **self.special_tokens}
        names = sorted(markers, key=len, reverse=True)
        while i < len(text):
            matched = False
            for name in names:
                if text.startswith(name, i):
                    out.append(markers[name])
                    i += len(name)
                    matched = True
                    break
            if not matched:
                out.extend(text[i].encode("utf-8"))
                i += 1
        return out

    def decode(self, ids: Sequence[int]) -> str:
        rev_special = {v: k for k, v in self.special_tokens.items()}
        rev_added = {v: k for k, v in self._added.items()}
        parts: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                parts.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if 0 <= i < self._base:
                byte_buf.append(i)
            elif i in rev_added:
                flush()
                parts.append(rev_added[i])
            elif i in rev_special:
                flush()  # special tokens are dropped from text output
            else:
                flush()
        flush()
        return "".join(parts)


class HFWhisperTokenizer(Tokenizer):
    """Adapter over a *local* transformers WhisperTokenizer."""

    def __init__(self, local_path: str, lang: str = "en", task: str = "transcribe"):
        from transformers import WhisperTokenizer

        self._tok = WhisperTokenizer.from_pretrained(
            local_path, local_files_only=True, language=lang, task=task
        )
        conv = self._tok.convert_tokens_to_ids
        self.special_tokens = {
            t: conv(t)
            for t in self._tok.all_special_tokens
            if conv(t) is not None
        }
        for code in WHISPER_LANGS:
            tid = conv(f"<|{code}|>")
            if tid is not None and tid != self._tok.unk_token_id:
                self.special_tokens[f"<|{code}|>"] = tid
        self.eot = conv("<|endoftext|>")
        self.sot = conv("<|startoftranscript|>")
        self.transcribe = conv("<|transcribe|>")
        self.no_timestamps = conv("<|notimestamps|>")

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def add_tokens(self, tokens: Iterable[str]) -> int:
        self._tok.add_tokens(list(tokens))
        return len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def get_tokenizer(
    name_or_path: Optional[str] = None, lang: str = "en"
) -> Tokenizer:
    """Factory: local BPE (vocab.json+merges.txt) or HF tokenizer when a
    path is given, else ByteTokenizer."""
    if name_or_path:
        import os

        if os.path.isdir(name_or_path) and os.path.exists(
            os.path.join(name_or_path, "merges.txt")
        ):
            return BPETokenizer.from_dir(name_or_path)
        if os.path.exists(name_or_path):
            return HFWhisperTokenizer(name_or_path, lang=lang)
    return ByteTokenizer()
