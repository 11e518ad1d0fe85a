"""Checkpoint checksum manifests (counterpart of the manifest half of
``paddle_tpu/io/checkpoint.py``, a copy of it in plain ``hashlib`` /
``json`` / ``os``).

A manifest is a ``manifest.json`` beside a checkpoint's files that names
each file's sha256 and byte count.  :func:`write_manifest` writes it last
and fsyncs it, so its presence marks a complete checkpoint;
:func:`verify_manifest` proves later that the files are the ones that
were committed.  The schema string keeps the reference's
``paddle_tpu.`` prefix, so a checkpoint directory written by either
package verifies in the other.

The orbax half of the reference module (``save_checkpoint``,
``load_checkpoint``, ``CheckpointManager``: sharded saves laid out on any
mesh) is not ported here; it belongs with the distributed slice.
"""

from __future__ import annotations

import hashlib
import json
import os

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = "paddle_tpu.io.checkpoint.manifest.v1"


def _sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def write_manifest(path, files=None, **extra):
    """Write a checksum manifest covering ``files`` (default: every regular
    file under ``path`` except the manifest itself) so a later restore can
    prove the checkpoint is the one that was committed — a flipped bit or a
    truncated write fails :func:`verify_manifest` instead of silently
    loading garbage.  The manifest is written LAST and fsynced, so its
    presence marks a complete checkpoint (the resilience layer's atomic-
    commit protocol renames the whole directory afterwards)."""
    path = os.path.abspath(str(path))
    if files is None:
        files = sorted(
            f for f in os.listdir(path)
            if f != MANIFEST_NAME and os.path.isfile(os.path.join(path, f)))
    doc = {"schema": MANIFEST_SCHEMA, "files": {}}
    doc.update(extra)
    for name in files:
        fp = os.path.join(path, name)
        doc["files"][name] = {"sha256": _sha256(fp),
                              "bytes": os.path.getsize(fp)}
    mp = os.path.join(path, MANIFEST_NAME)
    with open(mp, "w") as f:
        json.dump(doc, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    return doc


def verify_manifest(path):
    """Check a checkpoint directory against its manifest.  Returns
    ``(ok, problems)`` where ``problems`` names every missing file, size
    mismatch, or checksum mismatch (empty when ok)."""
    path = os.path.abspath(str(path))
    mp = os.path.join(path, MANIFEST_NAME)
    problems = []
    try:
        with open(mp) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return False, [f"manifest unreadable: {e!r}"]
    for name, want in doc.get("files", {}).items():
        fp = os.path.join(path, name)
        # OSError mid-check (file GC'd between stat and read, transient I/O
        # failure) must come back as a PROBLEM, not a raw crash — callers
        # quarantine-and-fall-back on problems but die on exceptions
        try:
            if not os.path.isfile(fp):
                problems.append(f"{name}: missing")
                continue
            size = os.path.getsize(fp)
            if size != want.get("bytes"):
                problems.append(
                    f"{name}: {size} bytes, manifest says {want.get('bytes')}")
                continue
            digest = _sha256(fp)
        except OSError as e:
            problems.append(f"{name}: unreadable ({e!r})")
            continue
        if digest != want.get("sha256"):
            problems.append(f"{name}: sha256 mismatch")
    return not problems, problems
