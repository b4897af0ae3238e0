"""Tokenizers (port of ``videop2p_tpu/utils/tokenizers.py``).

``WordTokenizer`` is deterministic and dependency-free, with CLIP-compatible
special ids: each lowercase word hashes to a stable id, so the control
layer's token alignment works without vocabulary files. With a random-init
text encoder it is the tokenizer the JAX package uses too, so both give the
same ids. ``CLIPTokenizerWrapper`` is the real CLIP BPE tokenizer of a
checkpoint's ``tokenizer/`` directory, through ``transformers`` (imported
when one is built); ``load_tokenizer`` picks between them as the JAX
package does.
"""

from __future__ import annotations

import hashlib
import os
import re
import warnings
from typing import List, Optional, Protocol

__all__ = ["Tokenizer", "WordTokenizer", "CLIPTokenizerWrapper", "load_tokenizer",
           "MAX_NUM_WORDS"]

# CLIP context length
MAX_NUM_WORDS = 77


class Tokenizer(Protocol):
    model_max_length: int
    bos_token_id: int
    eos_token_id: int

    def encode(self, text: str) -> List[int]:
        """Token ids including BOS/EOS (no padding)."""
        ...

    def decode_token(self, token_id: int) -> str:
        """Text piece for a single id."""
        ...

    def encode_padded(self, text: str) -> List[int]:
        """``model_max_length`` ids, EOS-padded."""
        ...


class _Padded:
    model_max_length = MAX_NUM_WORDS

    def encode_padded(self, text: str) -> List[int]:
        """``model_max_length`` ids, EOS-padded; a longer text is cut with
        EOS kept last."""
        ids = self.encode(text)
        if len(ids) > self.model_max_length:
            ids = ids[: self.model_max_length - 1] + [self.eos_token_id]
        return ids + [self.eos_token_id] * (self.model_max_length - len(ids))


class WordTokenizer(_Padded):
    """Each lowercase word hashes to an id in [0, vocab_size − 2); BOS/EOS
    take the last two ids. ``decode_token`` reads a reverse memo filled by
    ``encode``, which covers every id the control layer decodes."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self._reverse = {self.bos_token_id: "<|startoftext|>",
                         self.eos_token_id: "<|endoftext|>"}

    def _word_id(self, word: str) -> int:
        h = hashlib.sha1(word.encode("utf-8")).digest()
        return int.from_bytes(h[:4], "little") % (self.vocab_size - 2)

    def tokenize_words(self, text: str) -> List[str]:
        return [w for w in re.split(r"\s+", text.strip().lower()) if w]

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_token_id]
        for w in self.tokenize_words(text)[: self.model_max_length - 2]:
            wid = self._word_id(w)
            # linear probe on a hash collision
            while wid in self._reverse and self._reverse[wid] != w:
                wid = (wid + 1) % (self.vocab_size - 2)
            self._reverse[wid] = w
            ids.append(wid)
        ids.append(self.eos_token_id)
        return ids

    def decode_token(self, token_id: int) -> str:
        return self._reverse.get(int(token_id), "")


class CLIPTokenizerWrapper(_Padded):
    """The CLIP BPE tokenizer of a local checkpoint directory."""

    def __init__(self, path: str):
        from transformers import CLIPTokenizer

        self._tok = CLIPTokenizer.from_pretrained(path)
        self.model_max_length = int(self._tok.model_max_length)
        self.bos_token_id = int(self._tok.bos_token_id)
        self.eos_token_id = int(self._tok.eos_token_id)

    def encode(self, text: str) -> List[int]:
        return list(self._tok.encode(text))

    def decode_token(self, token_id: int) -> str:
        # '#' continuation markers stripped, as the reference does; CLIP's
        # '</w>' word ends are dropped by decode
        return self._tok.decode([int(token_id)]).strip("#")


def load_tokenizer(checkpoint_path: Optional[str]) -> Tokenizer:
    """The CLIP tokenizer of ``<checkpoint_path>/tokenizer`` when there is
    one, else the word tokenizer; when that directory does not load, a
    warning and the word tokenizer (the JAX package's behaviour)."""
    if checkpoint_path is not None:
        tok_dir = os.path.join(checkpoint_path, "tokenizer")
        if os.path.isdir(tok_dir):
            try:
                return CLIPTokenizerWrapper(tok_dir)
            except Exception as exc:
                warnings.warn(
                    f"failed to load CLIP tokenizer from {tok_dir!r} ({exc!r}); "
                    "falling back to WordTokenizer — token ids will NOT match "
                    "a real CLIP text encoder, so word-level edits may target "
                    "the wrong tokens", stacklevel=2)
    return WordTokenizer()
