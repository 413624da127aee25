"""Copied from ``xna_basecaller_tpu/data/fast5.py``;
only the package imports differ,
and ``h5py`` is imported where a file is read.

fast5 signal reading: h5py-based, multiprocessing directory scan.

Replaces the reference's ont-fast5-api reader (reference: ub-bonito/bonito/
fast5.py): raw DAC -> picoamps scaling from channel range/digitisation/
offset, start trim by peak detection, med/MAD normalisation (or
noisiest-section normalisation for short reads).  Supports both multi-read
fast5 (read_xxx groups) and single-read layouts.
"""

from __future__ import annotations

from glob import glob
from multiprocessing import Pool
from pathlib import Path

import numpy as np

MAD_FACTOR = 1.4826


def med_mad(x, factor: float = MAD_FACTOR):
    """Median and scaled median absolute deviation
    (reference fast5.py:174-180)."""
    med = np.median(x)
    mad = np.median(np.absolute(x - med)) * factor + np.finfo(np.float32).eps
    return med, mad


def trim(signal, window_size: int = 40, threshold_factor: float = 2.4,
         min_elements: int = 3):
    """Adapter/stall trimming by leading-peak detection, vectorised.

    Behaviour contract (reference fast5.py:149-171): with the threshold
    set from the trailing med/MAD, the trim point is the end of the first
    window at-or-after the first peak window whose final sample has
    dropped back below threshold; no peak -> keep everything past the
    fixed 10-sample prefix.
    """
    min_trim = 10
    sig = signal[min_trim:]
    med, mad = med_mad(sig[-(window_size * 100):])
    threshold = med + mad * threshold_factor
    nw = len(sig) // window_size
    if nw == 0:
        return min_trim, len(sig)
    windows = sig[: nw * window_size].reshape(nw, window_size)
    above = windows > threshold
    peaked = np.cumsum(above.sum(axis=1) > min_elements) > 0
    settled = np.flatnonzero(peaked & ~above[:, -1])
    if settled.size == 0:
        return min_trim, len(sig)
    end = int(settled[0] + 1) * window_size
    return min(end + min_trim, len(sig)), len(sig)


def norm_by_noisiest_section(signal, samples: int = 100,
                             threshold: float = 6.0):
    """Normalise by the longest high-noise region; used for short
    (<8000 sample) reads (behaviour of reference fast5.py:183-204).

    A 0/1 noise mask per fixed window (std above 1/threshold of the
    global std) feeds scipy find_peaks; the widest plateau supplies the
    med/MAD normalisation statistics.
    """
    threshold = signal.std() / threshold
    n = len(signal)
    nw = n // samples
    noise = np.ones(n)
    if nw:
        stds = signal[: nw * samples].reshape(nw, samples).std(axis=1)
        noise[: nw * samples] = np.repeat(
            (stds > threshold).astype(float), samples)
    noise[0] = 0
    noise[-1] = 0
    from scipy.signal import find_peaks
    peaks, info = find_peaks(noise, width=(None, None))
    if len(peaks):
        widest = np.argmax(info["widths"])
        med, mad = med_mad(
            signal[info["left_bases"][widest]: info["right_bases"][widest]])
    else:
        med, mad = med_mad(signal)
    return (signal - med) / mad


class Read:
    """One read: scaled + trimmed + normalised signal plus metadata
    (reference fast5.py:22-128)."""

    def __init__(self, read_id: str, raw: np.ndarray, channel_info: dict,
                 read_attrs: dict, filename: str = "", meta: bool = False):
        self.read_id = read_id
        self.filename = filename
        self.run_id = _dec(read_attrs.get("run_id", ""))
        self.sample_id = _dec(read_attrs.get("sample_id", "None"))
        self.range = float(channel_info.get("range", 1.0))
        self.digitisation = float(channel_info.get("digitisation", 1.0))
        self.offset = int(channel_info.get("offset", 0))
        self.sampling_rate = float(channel_info.get("sampling_rate", 4000.0))
        self.scaling = self.range / self.digitisation
        self.mux = int(read_attrs.get("start_mux", 0))
        self.read_number = int(read_attrs.get("read_number", 0))
        self.channel = _dec(channel_info.get("channel_number", "0"))
        self.start = float(read_attrs.get("start_time", 0)) \
            / self.sampling_rate
        self.duration = len(raw) / self.sampling_rate
        if meta:
            self.signal = None
            return
        scaled = np.array(self.scaling * (raw + self.offset),
                          dtype=np.float32)
        trim_start, _ = trim(scaled[:8000])
        scaled = scaled[trim_start:]
        self.template_start = self.start + trim_start / self.sampling_rate
        self.template_duration = (
            self.duration - trim_start / self.sampling_rate)
        if len(scaled) > 8000:
            med, mad = med_mad(scaled)
            self.signal = (scaled - med) / mad
        else:
            self.signal = norm_by_noisiest_section(scaled)

    def __repr__(self):
        return "Read('%s')" % self.read_id


def _dec(v):
    if isinstance(v, (bytes, np.bytes_)):
        return v.decode()
    return str(v)


def _iter_fast5_reads(filename: str, read_ids=None, skip: bool = False):
    try:
        import h5py  # imported here: hosts without h5py still import this
    except ImportError as e:
        raise RuntimeError("h5py is required for fast5 reading") from e
    with h5py.File(filename, "r") as fh:
        if "Raw" in fh:  # single-read fast5
            grp = fh["Raw/Reads"]
            for rname in grp:
                read = grp[rname]
                rid = _dec(read.attrs.get("read_id", rname))
                if read_ids is not None and ((rid in read_ids) == skip):
                    continue
                channel_info = dict(fh["UniqueGlobalKey/channel_id"].attrs)
                tracking = dict(fh["UniqueGlobalKey/tracking_id"].attrs)
                attrs = {**tracking, **dict(read.attrs)}
                yield Read(rid, read["Signal"][:], channel_info, attrs,
                           Path(filename).name)
        else:  # multi-read fast5
            for key in fh:
                if not key.startswith("read_"):
                    continue
                grp = fh[key]
                rid = _dec(grp.attrs.get("read_id", key[5:]))
                if read_ids is not None and ((rid in read_ids) == skip):
                    continue
                raw_grp = grp["Raw"]
                channel_info = dict(grp["channel_id"].attrs)
                attrs = {**dict(grp.attrs), **dict(raw_grp.attrs)}
                if "tracking_id" in grp:
                    attrs = {**dict(grp["tracking_id"].attrs), **attrs}
                yield Read(rid, raw_grp["Signal"][:], channel_info, attrs,
                           Path(filename).name)


def _read_file(args):
    filename, read_ids, skip = args
    return list(_iter_fast5_reads(filename, read_ids, skip))


def get_reads(directory: str, read_ids=None, skip: bool = False,
              n_proc: int = 8, recursive: bool = False, cancel=None):
    """Yield Reads from all fast5 files in a directory (reference
    fast5.py:284-297); files are parsed in a process pool."""
    pattern = "**/*.fast5" if recursive else "*.fast5"
    files = sorted(glob(f"{directory}/{pattern}", recursive=recursive))
    if not files:
        return
    if n_proc <= 1 or len(files) == 1:
        for f in files:
            yield from _iter_fast5_reads(f, read_ids, skip)
            if cancel is not None and cancel.is_set():
                return
        return
    with Pool(n_proc) as pool:
        for reads in pool.imap(
                _read_file, ((f, read_ids, skip) for f in files)):
            for read in reads:
                yield read
                if cancel is not None and cancel.is_set():
                    return


class ReadChunk:
    """Fixed-window slice of a read for ctc-data building
    (reference fast5.py:131-146)."""

    def __init__(self, read: Read, chunk: np.ndarray, i: int, n: int):
        self.read_id = "%s:%i:%i" % (read.read_id, i, n)
        self.run_id = read.run_id
        self.filename = read.filename
        self.mux = read.mux
        self.channel = read.channel
        self.start = read.start
        self.duration = read.duration
        self.template_start = self.start
        self.template_duration = self.duration
        self.signal = chunk

    def __repr__(self):
        return "ReadChunk('%s')" % self.read_id


def read_chunks(read, chunksize: int = 4000, overlap: int = 400):
    """Split a Read into fixed ReadChunks (reference fast5.py:207-219)."""
    if len(read.signal) < chunksize:
        return
    _, offset = divmod(len(read.signal) - chunksize, chunksize - overlap)
    signal = read.signal[offset:]
    n = (len(signal) - chunksize) // (chunksize - overlap) + 1
    for i in range(n):
        start = i * (chunksize - overlap)
        yield ReadChunk(read, signal[start:start + chunksize], i + 1, n)
