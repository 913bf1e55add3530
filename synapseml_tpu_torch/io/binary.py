"""Binary & image file datasources.

Reference: io/binary/BinaryFileFormat.scala (path+bytes DataFrame source) and
org/apache/spark/ml/source/image/PatchedImageFileFormat.scala (image schema
source). Here: directory walks producing Tables with (path, bytes) or
(path, image array) columns; image decode goes through ops/image so arrays
are ready for the card's preprocessing path (``ops/image.py``).

The port's copy of the JAX package's ``io/binary.py``. Decoding JPEG and PNG
needs Pillow; ``.npy`` files are loaded with numpy alone.
"""

from __future__ import annotations

import fnmatch
import os
from typing import List, Optional

import numpy as np

from ..core.table import Table

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".ppm", ".npy")


def _walk(path: str, pattern: Optional[str], recursive: bool) -> List[str]:
    out: List[str] = []
    if os.path.isfile(path):
        return [path]
    for root, dirs, files in os.walk(path):
        for f in sorted(files):
            if pattern is None or fnmatch.fnmatch(f, pattern):
                out.append(os.path.join(root, f))
        if not recursive:
            break
    return out


def read_binary_files(path: str, pattern: Optional[str] = None,
                      recursive: bool = True) -> Table:
    """Directory → Table(path, bytes) (BinaryFileFormat analog)."""
    paths = _walk(path, pattern, recursive)
    blobs = np.empty(len(paths), dtype=object)
    for i, p in enumerate(paths):
        with open(p, "rb") as f:
            blobs[i] = f.read()
    return Table({"path": np.asarray(paths, dtype=object), "bytes": blobs})


def read_image_dir(path: str, pattern: Optional[str] = None,
                   recursive: bool = True,
                   drop_invalid: bool = True) -> Table:
    """Directory → Table(path, image) with HWC float arrays
    (PatchedImageFileFormat analog; dropInvalid matches the reference's
    tolerant decode at ImageTransformer.scala:688-699)."""
    from ..ops.image import decode_image_bytes

    paths = [p for p in _walk(path, pattern, recursive)
             if p.lower().endswith(_IMAGE_EXTS)]
    imgs, kept = [], []
    for p in paths:
        try:
            if p.lower().endswith(".npy"):  # pre-decoded array file
                imgs.append(np.load(p))
            else:
                with open(p, "rb") as f:
                    imgs.append(decode_image_bytes(f.read()))
            kept.append(p)
        except Exception:
            if not drop_invalid:
                raise
    col = np.empty(len(imgs), dtype=object)
    for i, im in enumerate(imgs):
        col[i] = im
    return Table({"path": np.asarray(kept, dtype=object), "image": col})


def load_numeric_csv(path: str, has_header: bool = True) -> "np.ndarray":
    """Dense float32 ingest for training matrices: C++ fast path
    (native.read_numeric_csv) with a numpy fallback. Empty/unparseable
    fields become NaN (routed by the GBDT engine's learned default_left)."""
    from ..native import read_numeric_csv

    out = read_numeric_csv(path, has_header)
    if out is not None:
        return out
    # fallback matches the native reader's delimiter handling (comma or tab)
    with open(path) as f:
        first = f.readline()
    delim = "\t" if ("\t" in first and "," not in first) else ","
    out = np.genfromtxt(path, delimiter=delim,
                        skip_header=1 if has_header else 0,
                        dtype=np.float32)
    if out.ndim == 1:
        # genfromtxt flattens both 1-row and 1-column files; the first line
        # disambiguates: no delimiter there means a single-column file
        out = out.reshape(-1, 1) if delim not in first else out[None, :]
    return out
