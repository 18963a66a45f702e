"""What the kernel-variant scripts (``k1_variants.py``,
``segment_variants.py``, ``dot_variants.py``, ``row_variants.py``,
``stream_variants.py``) share: patched copies of a
kernel's sources, built with ``nvcc`` all at once and loaded with
``ctypes`` beside the tree's own library, and timings taken in turns.

A variant is a function from the text of one source file to its patched
text; :func:`constants` and :func:`replace` make the usual ones.
"""

import ctypes
import os
import re
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def constants(**values):
    """A variant setting ``constexpr int NAME = ...;`` (each set once in
    the file)."""
    def patch(text, what):
        for const, value in values.items():
            text, n = re.subn(r"(constexpr int %s = )\d+;" % const,
                              r"\g<1>%s;" % value, text)
            if n != 1:
                raise SystemExit(f"{what}: {const} is not set once")
        return text
    return patch


def replace(*pairs):
    """A variant replacing each ``old`` text (found once) by ``new``."""
    def patch(text, what):
        for old, new in pairs:
            if text.count(old) != 1:
                raise SystemExit(f"{what}: {old!r} is not in the source "
                                 "once; update the variant's patch")
            text = text.replace(old, new)
        return text
    return patch


def build(kernels, lib, variants, tool, patched=None):
    """One library a variant of ``csrc/<lib>.cu``: a copy of ``csrc``
    with ``patched`` (default ``<lib>.cu``) passed through the variant,
    under ``build/<tool>/<lib>/<name>/``; the ``nvcc`` runs start
    together. ``variants``: name -> patch (or None for the tree's
    source, or ``(file, patch)`` to patch another file of the copy, a
    shared header). Returns the loaded libraries by name."""
    root = os.path.join(HERE, "build", tool, lib)
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for name, patch in variants.items():
        d = os.path.join(root, name, "csrc")
        shutil.copytree(kernels.CSRC, d)
        path = os.path.join(d, patched or lib + ".cu")
        if isinstance(patch, tuple):
            path, patch = os.path.join(d, patch[0]), patch[1]
        if patch is not None:
            with open(path) as f:
                text = patch(f.read(), f"{tool} {lib} {name}")
            with open(path, "w") as f:
                f.write(text)
        out = os.path.join(root, name, lib + ".so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", out,
               os.path.join(d, lib + ".cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for name, out, proc in procs:
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"{tool}: nvcc failed for {lib} {name}:\n{log}")
        handle = ctypes.CDLL(out)
        for fn, argtypes in kernels.SIGNATURES[lib].items():
            f = getattr(handle, fn)
            f.argtypes = list(argtypes)
            f.restype = kernels.RESTYPES.get(fn, ctypes.c_int)
        handle.detpu_error_string.argtypes = [ctypes.c_int]
        handle.detpu_error_string.restype = ctypes.c_char_p
        libs[name] = handle
    return libs


def in_turns(names, use, measure, rounds=2):
    """``measure()`` after ``use(name)`` for each name, ``rounds`` times,
    the order reversed every other round; the measurements by name."""
    runs = {n: [] for n in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            use(name)
            runs[name].append(measure())
    return runs
