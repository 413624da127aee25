"""Copied from ``xna_basecaller_tpu/utils/fileio.py``;
only the package imports differ.

Atomic file-output helper.

Every resumable chain in this framework skips completed work by artifact
presence (fastq/paf/csv per phase).  A process killed mid-write — tunnel
drop, watchdog, machine reset — must never leave a partial file that the
relaunch mistakes for complete, so user-visible outputs go through a
tmp-file + rename.  The tmp name is PREFIXED (".tmp-<name>") so no
extension-shaped glob can ever match a leftover.
"""

from __future__ import annotations

import os
from contextlib import contextmanager


@contextmanager
def atomic_output(path: str, mode: str = "w"):
    """Open a tmp file for writing; rename onto ``path`` only on clean
    exit.  On an exception the tmp file is removed and ``path`` is left
    untouched (complete previous version or absent)."""
    tmp = os.path.join(os.path.dirname(path) or ".",
                       ".tmp-" + os.path.basename(path))
    fh = open(tmp, mode)
    try:
        yield fh
    except BaseException:
        fh.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fh.close()
    os.replace(tmp, path)
