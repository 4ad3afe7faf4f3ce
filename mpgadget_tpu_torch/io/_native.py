"""Native (C) IO accelerator for the bigfile layer.

The reference's runtime IO is C (depends/bigfile + petaio's striped
concurrent writers, petaio.c:180-260); this module provides the native
equivalent for the TPU port: a small C library, compiled once with the
system gcc and loaded through ctypes, that does

* SysV byte checksums at memory bandwidth (the pure-numpy fallback
  materializes a uint64 copy of every buffer written);
* striped multi-file writes/reads with one OpenMP thread per stripe
  file (the NumWriters concurrency analog on a single host).

Everything degrades gracefully to the pure-Python path when a compiler
is unavailable (`native_available()` is False).
"""

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_C_SRC = r"""
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <fcntl.h>
#include <unistd.h>

uint32_t sysv_sum(const unsigned char* buf, int64_t n) {
    uint64_t s = 0;
    int64_t i;
    #pragma omp parallel for reduction(+:s)
    for (i = 0; i < n; i++)
        s += buf[i];
    return (uint32_t)(s & 0xFFFFFFFFu);
}

/* Write nbytes[i] bytes from buf+buf_off[i] into paths[i] at byte
 * offset file_off[i]; one OpenMP thread per file.  Returns the number
 * of failed files; sums[i] gets the SysV byte sum of each chunk. */
int write_files(int nfiles, const char** paths,
                const int64_t* file_off, const unsigned char* buf,
                const int64_t* buf_off, const int64_t* nbytes,
                uint32_t* sums) {
    int nfail = 0;
    int i;
    #pragma omp parallel for reduction(+:nfail) schedule(dynamic)
    for (i = 0; i < nfiles; i++) {
        /* O_CREAT without O_TRUNC: a transient open failure (EMFILE/
         * EINTR under the thread fan-out) can never truncate data
         * already written to an existing stripe file. */
        int fd = open(paths[i], O_RDWR | O_CREAT, 0644);
        if (fd < 0) { nfail++; continue; }
        FILE* fh = fdopen(fd, "r+b");
        if (!fh) { close(fd); nfail++; continue; }
        if (fseeko(fh, (off_t)file_off[i], SEEK_SET) != 0 ||
            fwrite(buf + buf_off[i], 1, (size_t)nbytes[i], fh)
                != (size_t)nbytes[i])
            nfail++;
        fclose(fh);
        sums[i] = sysv_sum(buf + buf_off[i], nbytes[i]);
    }
    return nfail;
}

int read_files(int nfiles, const char** paths,
               const int64_t* file_off, unsigned char* buf,
               const int64_t* buf_off, const int64_t* nbytes) {
    int nfail = 0;
    int i;
    #pragma omp parallel for reduction(+:nfail) schedule(dynamic)
    for (i = 0; i < nfiles; i++) {
        FILE* fh = fopen(paths[i], "rb");
        if (!fh) { nfail++; continue; }
        if (fseeko(fh, (off_t)file_off[i], SEEK_SET) != 0 ||
            fread(buf + buf_off[i], 1, (size_t)nbytes[i], fh)
                != (size_t)nbytes[i])
            nfail++;
        fclose(fh);
    }
    return nfail;
}
"""

_lib = None
_tried = False


def _build():
    import hashlib
    cache = os.path.join(tempfile.gettempdir(),
                         f"mpgadget_tpu_native_{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    tag = hashlib.sha1(_C_SRC.encode()).hexdigest()[:12]
    so = os.path.join(cache, f"libmpgio_{tag}.so")
    src = os.path.join(cache, f"mpgio_{tag}.c")
    if not os.path.exists(so):
        with open(src, "w") as fh:
            fh.write(_C_SRC)
        subprocess.run(
            ["gcc", "-O3", "-march=native", "-fopenmp", "-shared",
             "-fPIC", src, "-o", so],
            check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(so)
    lib.sysv_sum.restype = ctypes.c_uint32
    lib.sysv_sum.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    lib.write_files.restype = ctypes.c_int
    lib.write_files.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), i64p,
        ctypes.c_char_p, i64p, i64p, u32p]
    lib.read_files.restype = ctypes.c_int
    lib.read_files.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), i64p,
        ctypes.c_char_p, i64p, i64p]
    return lib


def get_lib():
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = _build()
        except Exception:
            _lib = None
    return _lib


def native_available():
    return get_lib() is not None


def sysv_sum(data: bytes) -> int:
    lib = get_lib()
    if lib is None:
        return int(np.frombuffer(data, np.uint8).astype(np.uint64)
                   .sum() & 0xFFFFFFFF)
    return int(lib.sysv_sum(data, len(data)))


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def write_striped(paths, file_off, buf, buf_off, nbytes):
    """Parallel striped write; returns per-file SysV sums or None if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    sums = np.zeros(n, np.uint32)
    rc = lib.write_files(
        n, _paths_array(paths),
        np.ascontiguousarray(file_off, np.int64), buf,
        np.ascontiguousarray(buf_off, np.int64),
        np.ascontiguousarray(nbytes, np.int64), sums)
    if rc:
        raise IOError(f"native striped write failed on {rc} files")
    return sums


def read_striped(paths, file_off, nbytes_total, buf_off, nbytes):
    """Parallel striped read into one buffer; returns bytes or None."""
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(int(nbytes_total))
    rc = lib.read_files(
        len(paths), _paths_array(paths),
        np.ascontiguousarray(file_off, np.int64), buf,
        np.ascontiguousarray(buf_off, np.int64),
        np.ascontiguousarray(nbytes, np.int64))
    if rc:
        raise IOError(f"native striped read failed on {rc} files")
    return buf.raw
