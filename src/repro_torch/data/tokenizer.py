"""Deterministic character-level tokenizer for the self-contained RLVR tasks.

Specials:
  PAD=0 BOS=1 EOS=2 SEP=3 CALL=4 ENDCALL=5 RESP=6 ENDRESP=7
CALL/ENDCALL bracket an agentic tool invocation; RESP/ENDRESP bracket the
environment's force-fed response tokens (excluded from the GRPO loss mask).

A copy of ``repro.data.tokenizer``: the port keeps its own so that it imports nothing
of the JAX package.
"""
from __future__ import annotations

from typing import List

PAD, BOS, EOS, SEP, CALL, ENDCALL, RESP, ENDRESP = range(8)
SPECIALS = ["<pad>", "<bos>", "<eos>", "<sep>", "<call>", "<endcall>",
            "<resp>", "<endresp>"]

_CHARS = "0123456789+-*/=?abcdefghijklmnopqrstuvwxyz ()."
CHAR_TO_ID = {c: i + len(SPECIALS) for i, c in enumerate(_CHARS)}
ID_TO_CHAR = {i: c for c, i in CHAR_TO_ID.items()}

VOCAB_SIZE = len(SPECIALS) + len(_CHARS)


def encode(text: str) -> List[int]:
    return [CHAR_TO_ID[c] for c in text if c in CHAR_TO_ID]


def decode(ids) -> str:
    return "".join(ID_TO_CHAR.get(int(i), "") for i in ids)


def decode_with_specials(ids) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i < len(SPECIALS):
            out.append(SPECIALS[i])
        else:
            out.append(ID_TO_CHAR.get(i, ""))
    return "".join(out)
