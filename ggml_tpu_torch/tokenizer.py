"""Tokenizers built from GGUF metadata — the port's own copy of
ggml_tpu/tokenizer.py: GPT-2 byte-level BPE (analog of gpt_tokenize/gpt_vocab,
reference: examples/common.cpp:236-334), SentencePiece and WordPiece.

Loads vocab + merges from GGUF metadata (tokenizer.ggml.tokens/merges).
`learn_merges` learns byte-level BPE merges from a text, for vocabularies made
where no tokenizer file is shipped (tests, smoke runs).
"""

from __future__ import annotations

import re
from collections import Counter
from functools import lru_cache


@lru_cache()
def bytes_to_unicode():
    """Standard GPT-2 byte<->unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\w\d]+|\s+(?!\S)|\s+|[\w\d]+""", re.UNICODE)


def learn_merges(text: str, n_merges: int) -> list[str]:
    """Byte-level BPE merges learned from `text`: the chunks of _PAT as byte
    symbols, then n_merges times the most frequent adjacent pair (ties to the
    larger pair) merged everywhere.  The vocabulary is the 256 byte symbols
    followed by every merge result (see byte_level_vocab)."""
    b2u = bytes_to_unicode()
    words = Counter(tuple(b2u[b] for b in w.encode("utf-8")) for w in _PAT.findall(text))
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for sym, c in words.items():
            for pair in zip(sym, sym[1:]):
                pairs[pair] += c
        if not pairs:
            break
        a, b = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(f"{a} {b}")
        merged = Counter()
        for sym, c in words.items():
            out, i = [], 0
            while i < len(sym):
                if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(sym[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def byte_level_vocab(merges: list[str]) -> list[str]:
    """The 256 byte symbols in byte order, then each merge's result once."""
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    seen = set(tokens)
    for m in merges:
        t = m.replace(" ", "")
        if t not in seen:
            seen.add(t)
            tokens.append(t)
    return tokens


class BPETokenizer:
    def __init__(self, tokens: list[str], merges: list[str]):
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.decoder = dict(enumerate(tokens))
        self.bpe_ranks = {tuple(m.split(" ")): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_gguf(cls, g):
        return cls(list(g.metadata["tokenizer.ggml.tokens"]), list(g.metadata.get("tokenizer.ggml.merges", [])))

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids = []
        for chunk in _PAT.findall(text):
            chunk = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(chunk):
                if piece in self.encoder:
                    ids.append(self.encoder[piece])
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        data = bytearray(self.byte_decoder.get(c, ord("?")) for c in text)
        return data.decode("utf-8", errors="replace")


class SPMTokenizer:
    """SentencePiece-style tokenizer for llama-family GGUFs.

    reference analog: llama.cpp's llm_tokenizer_spm (consumes the same
    tokenizer.ggml.tokens/scores/token_type metadata): text is split into
    UTF-8 symbols (with ' ' mapped to the U+2581 underline), then adjacent
    pieces are greedily merged in best-score order; bytes fall back to the
    <0xNN> byte tokens.
    """

    SPACE = "▁"

    def __init__(self, tokens: list[str], scores: list[float], add_bos: bool = True, bos_id: int = 1):
        self.tokens = list(tokens)
        self.scores = list(scores)
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.add_bos = add_bos
        self.bos_id = bos_id
        self.byte_ids = {}
        for i, t in enumerate(tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                self.byte_ids[int(t[3:5], 16)] = i

    @classmethod
    def from_gguf(cls, g):
        md = g.metadata
        toks = list(md["tokenizer.ggml.tokens"])
        scores = list(md.get("tokenizer.ggml.scores", [0.0] * len(toks)))
        bos = int(md.get("tokenizer.ggml.bos_token_id", 1))
        return cls(toks, scores, bos_id=bos)

    def encode(self, text: str, add_bos: bool | None = None) -> list[int]:
        text = self.SPACE + text.replace(" ", self.SPACE)
        pieces = list(text)
        # greedy best-score merge of adjacent pieces (llm_tokenizer_spm order)
        while len(pieces) > 1:
            best_score, best_i = -1e30, -1
            for i in range(len(pieces) - 1):
                cand = pieces[i] + pieces[i + 1]
                j = self.encoder.get(cand)
                if j is not None and self.scores[j] > best_score:
                    best_score, best_i = self.scores[j], i
            if best_i < 0:
                break
            pieces[best_i : best_i + 2] = [pieces[best_i] + pieces[best_i + 1]]
        ids = []
        if add_bos if add_bos is not None else self.add_bos:
            ids.append(self.bos_id)
        for p in pieces:
            j = self.encoder.get(p)
            if j is not None:
                ids.append(j)
            else:  # byte fallback
                for b in p.encode("utf-8"):
                    ids.append(self.byte_ids.get(b, 0))
        return ids

    def decode(self, ids) -> str:
        out = []
        i = 0
        ids = [int(v) for v in ids]
        while i < len(ids):
            t = self.tokens[ids[i]]
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                bs = bytearray()
                while i < len(ids):
                    tt = self.tokens[ids[i]]
                    if len(tt) == 6 and tt.startswith("<0x") and tt.endswith(">"):
                        bs.append(int(tt[3:5], 16))
                        i += 1
                    else:
                        break
                out.append(bs.decode("utf-8", errors="replace"))
                continue
            out.append(t.replace(self.SPACE, " "))
            i += 1
        s = "".join(out)
        return s[1:] if s.startswith(" ") else s


class WPMTokenizer:
    """WordPiece tokenizer for BERT-family GGUFs.

    reference analog: llama.cpp's llm_tokenizer_wpm (consumes the same
    tokenizer.ggml.tokens metadata, tokenizer.ggml.model == 'bert'): text is
    lowercased and split on whitespace/punctuation, then each word is
    greedily longest-prefix matched against the vocab, continuations
    carrying the '##' prefix; a word with no match becomes [UNK].
    """

    def __init__(self, tokens: list[str], unk_id: int | None = None,
                 cls_id: int | None = None, sep_id: int | None = None):
        self.tokens = list(tokens)
        self.encoder = {t: i for i, t in enumerate(tokens)}
        self.unk_id = unk_id if unk_id is not None else self.encoder.get("[UNK]", 0)
        self.cls_id = cls_id if cls_id is not None else self.encoder.get("[CLS]")
        self.sep_id = sep_id if sep_id is not None else self.encoder.get("[SEP]")

    @classmethod
    def from_gguf(cls, g):
        md = g.metadata
        toks = list(md["tokenizer.ggml.tokens"])
        return cls(
            toks,
            unk_id=int(md["tokenizer.ggml.unknown_token_id"])
            if "tokenizer.ggml.unknown_token_id" in md else None,
            cls_id=int(md["tokenizer.ggml.cls_token_id"])
            if "tokenizer.ggml.cls_token_id" in md else None,
            sep_id=int(md["tokenizer.ggml.seperator_token_id"])
            if "tokenizer.ggml.seperator_token_id" in md else None,
        )

    @staticmethod
    def _basic_split(text: str) -> list[str]:
        """lowercase + whitespace split + punctuation isolation (BERT
        BasicTokenizer without the CJK/accent handling)."""
        import unicodedata

        out, word = [], []
        for ch in text.lower():
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif unicodedata.category(ch).startswith("P"):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> list[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                j = self.encoder.get(piece)
                if j is not None:
                    cur = j
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]  # whole word -> [UNK]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        ids = []
        if add_special and self.cls_id is not None:
            ids.append(self.cls_id)
        for word in self._basic_split(text):
            ids.extend(self._wordpiece(word))
        if add_special and self.sep_id is not None:
            ids.append(self.sep_id)
        return ids

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            t = self.tokens[int(i)]
            if t in ("[CLS]", "[SEP]", "[PAD]"):
                continue
            if t.startswith("##"):
                out.append(t[2:])
            else:
                if out:
                    out.append(" ")
                out.append(t)
        return "".join(out)
