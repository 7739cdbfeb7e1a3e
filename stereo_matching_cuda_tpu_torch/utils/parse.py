"""Shared error contract for the hand-written binary codecs.

A copy of ``stereo_matching_cuda_tpu/utils/parse.py``, names and
behaviour kept: importing the JAX package imports JAX, which the port's
machines need not have.

The package promises clean ``ValueError`` diagnostics for bad input
files (the CLI maps them to ``error: ...`` + exit 2; serve.py to HTTP
400).  Hand-rolled decoders naturally trip lower-level exceptions on
malformed bytes — ``IndexError`` walking a truncated GIF block chain,
``struct.error`` on a short BMP header, ``StopIteration`` on a JPEG
DHT with fewer symbols than counts, ``KeyError`` on an out-of-range
PNG palette index — so every reader
entry point wraps its body with :func:`codec_errors` to convert those
to the contract without hiding genuine ``ValueError``/
``NotImplementedError``/``OSError`` diagnostics.
"""

from __future__ import annotations

import functools
import struct


def codec_errors(fmt: str):
    """Decorator: unexpected parse-time exceptions → ValueError."""

    def deco(fn):
        @functools.wraps(fn)
        def wrap(path, *a, **k):
            try:
                return fn(path, *a, **k)
            except (ValueError, NotImplementedError, OSError):
                raise
            except (IndexError, KeyError, struct.error, StopIteration,
                    OverflowError, EOFError) as e:
                raise ValueError(
                    f"{path}: corrupt {fmt} file "
                    f"({type(e).__name__}: {e})") from e

        return wrap

    return deco
