// libckzg_tpu.so: the c-kzg-4844 C ABI, implemented by embedding CPython
// and dispatching to the kzg_tpu_torch package
// (kzg_tpu_torch/c_abi_host.py), which runs on the card.
//
// The CKZGSettings struct is filled with the settings' arrays in blst's
// layouts (roots of unity, setup points, FK20 column points), so a caller
// that reads them sees the same values as from c-kzg-4844; the fixed-base
// tables stay on the device.
//
// Build: python3 -m kzg_tpu_torch.c_abi_build -> build/abi/<key>/libckzg_tpu.so
// (the compiled-in repo root is KZG_TPU_DEFAULT_ROOT; KZG_TPU_PYROOT
// overrides it at run time).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

#include "ckzg_tpu.h"

namespace {

std::mutex g_mu;
bool g_inited = false;
PyObject *g_mod = nullptr;  // kzg_tpu_torch.c_abi_host
// CKZGSettings* -> python settings handle
std::map<const CKZGSettings *, long> g_handles;

bool ensure_python() {
    std::lock_guard<std::mutex> lk(g_mu);
    if (g_inited) return g_mod != nullptr;
    g_inited = true;
    bool we_initialized = false;
    if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        we_initialized = true;
    }
    PyGILState_STATE st = PyGILState_Ensure();
    // sys.path: env override, then compiled-in repo root
    const char *root = getenv("KZG_TPU_PYROOT");
#ifdef KZG_TPU_DEFAULT_ROOT
    if (!root) root = KZG_TPU_DEFAULT_ROOT;
#endif
    if (root) {
        PyObject *sys_path = PySys_GetObject("path");
        if (sys_path) {
            PyObject *p = PyUnicode_FromString(root);
            PyList_Insert(sys_path, 0, p);
            Py_XDECREF(p);
        }
    }
    g_mod = PyImport_ImportModule("kzg_tpu_torch.c_abi_host");
    if (!g_mod) PyErr_Print();
    PyGILState_Release(st);
    if (we_initialized) {
        // Py_InitializeEx left this thread holding the GIL outside any
        // PyGILState pairing; release it so other threads can Ensure.
        PyEval_SaveThread();
    }
    return g_mod != nullptr;
}

struct Gil {
    PyGILState_STATE st;
    Gil() { st = PyGILState_Ensure(); }
    ~Gil() { PyGILState_Release(st); }
};

// Call host fn returning (ret:int, payload:bytes|None); copy payload into
// out (expected size n_out) when ret == OK.
C_KZG_RET call_bytes_out(const char *fn, PyObject *args, uint8_t *out, size_t n_out) {
    Gil gil;
    PyObject *f = PyObject_GetAttrString(g_mod, fn);
    if (!f) { PyErr_Clear(); Py_XDECREF(args); return C_KZG_ERROR; }
    PyObject *r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) { PyErr_Print(); return C_KZG_ERROR; }
    C_KZG_RET ret = C_KZG_ERROR;
    if (PyTuple_Check(r) && PyTuple_Size(r) == 2) {
        ret = (C_KZG_RET)PyLong_AsLong(PyTuple_GetItem(r, 0));
        PyObject *payload = PyTuple_GetItem(r, 1);
        if (ret == C_KZG_OK && out != nullptr) {
            char *buf = nullptr;
            Py_ssize_t len = 0;
            if (payload == Py_None ||
                PyBytes_AsStringAndSize(payload, &buf, &len) != 0 ||
                (size_t)len != n_out) {
                PyErr_Clear();
                ret = C_KZG_ERROR;
            } else {
                memcpy(out, buf, n_out);
            }
        }
    }
    Py_DECREF(r);
    return ret;
}

// Call host fn returning (ret:int, flag:int); write flag to *ok.
C_KZG_RET call_flag_out(const char *fn, PyObject *args, bool *ok) {
    Gil gil;
    PyObject *f = PyObject_GetAttrString(g_mod, fn);
    if (!f) { PyErr_Clear(); Py_XDECREF(args); return C_KZG_ERROR; }
    PyObject *r = PyObject_CallObject(f, args);
    Py_DECREF(f);
    Py_XDECREF(args);
    if (!r) { PyErr_Print(); return C_KZG_ERROR; }
    C_KZG_RET ret = C_KZG_ERROR;
    if (PyTuple_Check(r) && PyTuple_Size(r) == 2) {
        ret = (C_KZG_RET)PyLong_AsLong(PyTuple_GetItem(r, 0));
        if (ok) *ok = PyLong_AsLong(PyTuple_GetItem(r, 1)) != 0;
    }
    Py_DECREF(r);
    return ret;
}

long handle_for(const CKZGSettings *s) {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_handles.find(s);
    return it == g_handles.end() ? -1 : it->second;
}

// Fill the CKZGSettings arrays from the host's blst-layout payloads.
C_KZG_RET fill_settings(CKZGSettings *out, long handle) {
    Gil gil;
    PyObject *r = PyObject_CallMethod(g_mod, "settings_arrays", "l", handle);
    if (!r) { PyErr_Print(); return C_KZG_ERROR; }
    C_KZG_RET ret = C_KZG_ERROR;
    memset(out, 0, sizeof *out);
    do {
        if (!PyTuple_Check(r) || PyTuple_Size(r) != 2) break;
        long rc = PyLong_AsLong(PyTuple_GetItem(r, 0));
        if (rc != 0) { ret = (C_KZG_RET)rc; break; }
        PyObject *lst = PyTuple_GetItem(r, 1);
        if (!PyList_Check(lst) || PyList_Size(lst) != 7) break;
        char *bufs[7]; Py_ssize_t lens[7];
        bool bad = false;
        for (int i = 0; i < 7; i++) {
            if (PyBytes_AsStringAndSize(PyList_GetItem(lst, i), &bufs[i], &lens[i]) != 0) {
                PyErr_Clear();
                bad = true;
                break;
            }
        }
        if (bad) break;
        auto dup = [](const char *src, Py_ssize_t n) -> void * {
            void *p = malloc(n ? n : 1);
            if (p) memcpy(p, src, n);
            return p;
        };
        out->roots_of_unity = (ckzg_fr *)dup(bufs[0], lens[0]);
        out->brp_roots_of_unity = (ckzg_fr *)dup(bufs[1], lens[1]);
        out->reverse_roots_of_unity = (ckzg_fr *)dup(bufs[2], lens[2]);
        out->g1_values_monomial = (ckzg_p1 *)dup(bufs[3], lens[3]);
        out->g1_values_lagrange_brp = (ckzg_p1 *)dup(bufs[4], lens[4]);
        out->g2_values_monomial = (ckzg_p2 *)dup(bufs[5], lens[5]);
        // x_ext_fft_columns: array of column pointers into one block
        size_t ncols = CELLS_PER_EXT_BLOB_;
        size_t col_elems = (size_t)lens[6] / sizeof(ckzg_p1) / ncols;
        ckzg_p1 *block = (ckzg_p1 *)dup(bufs[6], lens[6]);
        ckzg_p1 **cols = (ckzg_p1 **)malloc(ncols * sizeof(ckzg_p1 *));
        if (block && cols)
            for (size_t i = 0; i < ncols; i++) cols[i] = block + i * col_elems;
        out->x_ext_fft_columns = cols;
        out->tables = nullptr;   // the tables live on the device (settings.py)
        out->wbits = 0;
        out->scratch_size = 0;
        if (!out->roots_of_unity || !out->brp_roots_of_unity ||
            !out->reverse_roots_of_unity || !out->g1_values_monomial ||
            !out->g1_values_lagrange_brp || !out->g2_values_monomial ||
            !block || !cols) {
            ret = C_KZG_MALLOC;
            break;
        }
        ret = C_KZG_OK;
    } while (0);
    Py_DECREF(r);
    return ret;
}

}  // namespace

extern "C" {

C_KZG_RET load_trusted_setup(
    CKZGSettings *out,
    const uint8_t *g1_monomial_bytes, uint64_t num_g1_monomial_bytes,
    const uint8_t *g1_lagrange_bytes, uint64_t num_g1_lagrange_bytes,
    const uint8_t *g2_monomial_bytes, uint64_t num_g2_monomial_bytes,
    uint64_t precompute) {
    (void)precompute;  // the tables are built on the device and cached on disk
    if (!out || !g1_monomial_bytes || !g1_lagrange_bytes || !g2_monomial_bytes)
        return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long handle = -1;
    {
        Gil gil;
        PyObject *r = PyObject_CallMethod(
            g_mod, "load_trusted_setup", "y#y#y#",
            (const char *)g1_monomial_bytes, (Py_ssize_t)num_g1_monomial_bytes,
            (const char *)g1_lagrange_bytes, (Py_ssize_t)num_g1_lagrange_bytes,
            (const char *)g2_monomial_bytes, (Py_ssize_t)num_g2_monomial_bytes);
        if (!r) { PyErr_Print(); return C_KZG_ERROR; }
        long rc = PyLong_AsLong(PyTuple_GetItem(r, 0));
        handle = PyLong_AsLong(PyTuple_GetItem(r, 1));
        Py_DECREF(r);
        if (rc != 0) return (C_KZG_RET)rc;
    }
    C_KZG_RET ret = fill_settings(out, handle);
    if (ret != C_KZG_OK) return ret;
    std::lock_guard<std::mutex> lk(g_mu);
    g_handles[out] = handle;
    return C_KZG_OK;
}

C_KZG_RET load_trusted_setup_file(CKZGSettings *out, FILE *in, uint64_t precompute) {
    (void)precompute;
    if (!out || !in) return C_KZG_BADARGS;
    // read the whole file; the host module parses it
    std::string contents;
    char buf[65536];
    size_t n;
    while ((n = fread(buf, 1, sizeof buf, in)) > 0) contents.append(buf, n);
    if (!ensure_python()) return C_KZG_ERROR;
    long handle = -1;
    {
        Gil gil;
        PyObject *r = PyObject_CallMethod(g_mod, "load_trusted_setup_contents",
                                          "y#", contents.data(),
                                          (Py_ssize_t)contents.size());
        if (!r) { PyErr_Print(); return C_KZG_ERROR; }
        long rc = PyLong_AsLong(PyTuple_GetItem(r, 0));
        handle = PyLong_AsLong(PyTuple_GetItem(r, 1));
        Py_DECREF(r);
        if (rc != 0) return (C_KZG_RET)rc;
    }
    C_KZG_RET ret = fill_settings(out, handle);
    if (ret != C_KZG_OK) return ret;
    std::lock_guard<std::mutex> lk(g_mu);
    g_handles[out] = handle;
    return C_KZG_OK;
}

void free_trusted_setup(CKZGSettings *s) {
    if (!s) return;
    long handle = -1;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_handles.find(s);
        if (it != g_handles.end()) {
            handle = it->second;
            g_handles.erase(it);
        }
    }
    if (handle >= 0 && g_mod) {
        Gil gil;
        PyObject *r = PyObject_CallMethod(g_mod, "free_trusted_setup", "l", handle);
        Py_XDECREF(r);
    }
    free(s->roots_of_unity);
    free(s->brp_roots_of_unity);
    free(s->reverse_roots_of_unity);
    free(s->g1_values_monomial);
    free(s->g1_values_lagrange_brp);
    free(s->g2_values_monomial);
    if (s->x_ext_fft_columns) {
        free(s->x_ext_fft_columns[0]);  // single block
        free(s->x_ext_fft_columns);
    }
    memset(s, 0, sizeof *s);
}

C_KZG_RET blob_to_kzg_commitment(KZGCommitment *out, const Blob *blob, const CKZGSettings *s) {
    if (!out || !blob || !s) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    Gil gil;
    PyObject *args = Py_BuildValue("(y#l)", (const char *)blob->bytes,
                                   (Py_ssize_t)sizeof blob->bytes, h);
    return call_bytes_out("blob_to_kzg_commitment", args, out->bytes, 48);
}

C_KZG_RET compute_kzg_proof(KZGProof *proof_out, Bytes32 *y_out, const Blob *blob,
                            const Bytes32 *z_bytes, const CKZGSettings *s) {
    if (!proof_out || !y_out || !blob || !z_bytes || !s) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    uint8_t tmp[80];
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#l)", (const char *)blob->bytes, (Py_ssize_t)sizeof blob->bytes,
        (const char *)z_bytes->bytes, (Py_ssize_t)32, h);
    C_KZG_RET ret = call_bytes_out("compute_kzg_proof", args, tmp, 80);
    if (ret == C_KZG_OK) {
        memcpy(proof_out->bytes, tmp, 48);
        memcpy(y_out->bytes, tmp + 48, 32);
    }
    return ret;
}

C_KZG_RET compute_blob_kzg_proof(KZGProof *out, const Blob *blob,
                                 const Bytes48 *commitment_bytes, const CKZGSettings *s) {
    if (!out || !blob || !commitment_bytes || !s) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#l)", (const char *)blob->bytes, (Py_ssize_t)sizeof blob->bytes,
        (const char *)commitment_bytes->bytes, (Py_ssize_t)48, h);
    return call_bytes_out("compute_blob_kzg_proof", args, out->bytes, 48);
}

C_KZG_RET verify_kzg_proof(bool *ok, const Bytes48 *commitment_bytes,
                           const Bytes32 *z_bytes, const Bytes32 *y_bytes,
                           const Bytes48 *proof_bytes, const CKZGSettings *s) {
    if (!ok || !commitment_bytes || !z_bytes || !y_bytes || !proof_bytes || !s)
        return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#y#y#l)",
        (const char *)commitment_bytes->bytes, (Py_ssize_t)48,
        (const char *)z_bytes->bytes, (Py_ssize_t)32,
        (const char *)y_bytes->bytes, (Py_ssize_t)32,
        (const char *)proof_bytes->bytes, (Py_ssize_t)48, h);
    return call_flag_out("verify_kzg_proof", args, ok);
}

C_KZG_RET verify_blob_kzg_proof(bool *ok, const Blob *blob,
                                const Bytes48 *commitment_bytes,
                                const Bytes48 *proof_bytes, const CKZGSettings *s) {
    if (!ok || !blob || !commitment_bytes || !proof_bytes || !s) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#y#l)", (const char *)blob->bytes, (Py_ssize_t)sizeof blob->bytes,
        (const char *)commitment_bytes->bytes, (Py_ssize_t)48,
        (const char *)proof_bytes->bytes, (Py_ssize_t)48, h);
    return call_flag_out("verify_blob_kzg_proof", args, ok);
}

C_KZG_RET verify_blob_kzg_proof_batch(bool *ok, const Blob *blobs,
                                      const Bytes48 *commitments_bytes,
                                      const Bytes48 *proofs_bytes, uint64_t n,
                                      const CKZGSettings *s) {
    if (!ok || !s || (n > 0 && (!blobs || !commitments_bytes || !proofs_bytes)))
        return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#y#Kl)",
        (const char *)blobs, (Py_ssize_t)(n * sizeof(Blob)),
        (const char *)commitments_bytes, (Py_ssize_t)(n * 48),
        (const char *)proofs_bytes, (Py_ssize_t)(n * 48),
        (unsigned long long)n, h);
    return call_flag_out("verify_blob_kzg_proof_batch", args, ok);
}

C_KZG_RET compute_cells_and_kzg_proofs(Cell *cells, KZGProof *proofs, const Blob *blob,
                                       const CKZGSettings *s) {
    // matching c-kzg-4844: either output may be NULL to skip it, but not both
    if ((!cells && !proofs) || !blob || !s) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    const size_t n_cells_b = (size_t)CELLS_PER_EXT_BLOB_ * BYTES_PER_CELL_;
    const size_t n_proofs_b = (size_t)CELLS_PER_EXT_BLOB_ * 48;
    uint8_t *tmp = (uint8_t *)malloc(n_cells_b + n_proofs_b);
    if (!tmp) return C_KZG_MALLOC;
    Gil gil;
    PyObject *args = Py_BuildValue("(y#l)", (const char *)blob->bytes,
                                   (Py_ssize_t)sizeof blob->bytes, h);
    C_KZG_RET ret =
        call_bytes_out("compute_cells_and_kzg_proofs", args, tmp, n_cells_b + n_proofs_b);
    if (ret == C_KZG_OK) {
        if (cells) memcpy(cells, tmp, n_cells_b);
        if (proofs) memcpy(proofs, tmp + n_cells_b, n_proofs_b);
    }
    free(tmp);
    return ret;
}

C_KZG_RET recover_cells_and_kzg_proofs(Cell *recovered_cells, KZGProof *recovered_proofs,
                                       const uint64_t *cell_indices, const Cell *cells,
                                       uint64_t num_cells, const CKZGSettings *s) {
    if (!recovered_cells || !cell_indices || !cells || !s) return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    const size_t n_cells_b = (size_t)CELLS_PER_EXT_BLOB_ * BYTES_PER_CELL_;
    const size_t n_proofs_b = (size_t)CELLS_PER_EXT_BLOB_ * 48;
    uint8_t *tmp = (uint8_t *)malloc(n_cells_b + n_proofs_b);
    if (!tmp) return C_KZG_MALLOC;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#Kl)",
        (const char *)cell_indices, (Py_ssize_t)(num_cells * 8),
        (const char *)cells, (Py_ssize_t)(num_cells * sizeof(Cell)),
        (unsigned long long)num_cells, h);
    C_KZG_RET ret =
        call_bytes_out("recover_cells_and_kzg_proofs", args, tmp, n_cells_b + n_proofs_b);
    if (ret == C_KZG_OK) {
        memcpy(recovered_cells, tmp, n_cells_b);
        if (recovered_proofs) memcpy(recovered_proofs, tmp + n_cells_b, n_proofs_b);
    }
    free(tmp);
    return ret;
}

C_KZG_RET compute_verify_cell_kzg_proof_batch_challenge(
    ckzg_fr *challenge_out,
    const Bytes48 *commitment_bytes, uint64_t num_commitments,
    const uint64_t *commitment_indices, const uint64_t *cell_indices,
    const Cell *cells, const Bytes48 *proofs_bytes, uint64_t num_cells) {
    if (!challenge_out ||
        (num_commitments > 0 && !commitment_bytes) ||
        (num_cells > 0 &&
         (!commitment_indices || !cell_indices || !cells || !proofs_bytes)))
        return C_KZG_BADARGS;
    memset(challenge_out, 0, sizeof *challenge_out);
    if (!ensure_python()) return C_KZG_ERROR;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#Ky#y#y#y#K)",
        (const char *)commitment_bytes, (Py_ssize_t)(num_commitments * 48),
        (unsigned long long)num_commitments,
        (const char *)commitment_indices, (Py_ssize_t)(num_cells * 8),
        (const char *)cell_indices, (Py_ssize_t)(num_cells * 8),
        (const char *)cells, (Py_ssize_t)(num_cells * sizeof(Cell)),
        (const char *)proofs_bytes, (Py_ssize_t)(num_cells * 48),
        (unsigned long long)num_cells);
    return call_bytes_out("compute_verify_cell_kzg_proof_batch_challenge", args,
                          (uint8_t *)challenge_out, sizeof *challenge_out);
}

C_KZG_RET verify_cell_kzg_proof_batch(bool *ok, const Bytes48 *commitments_bytes,
                                      const uint64_t *cell_indices, const Cell *cells,
                                      const Bytes48 *proofs_bytes, uint64_t num_cells,
                                      const CKZGSettings *s) {
    if (!ok || !s ||
        (num_cells > 0 && (!commitments_bytes || !cell_indices || !cells || !proofs_bytes)))
        return C_KZG_BADARGS;
    if (!ensure_python()) return C_KZG_ERROR;
    long h = handle_for(s);
    if (h < 0) return C_KZG_BADARGS;
    Gil gil;
    PyObject *args = Py_BuildValue(
        "(y#y#y#y#Kl)",
        (const char *)commitments_bytes, (Py_ssize_t)(num_cells * 48),
        (const char *)cell_indices, (Py_ssize_t)(num_cells * 8),
        (const char *)cells, (Py_ssize_t)(num_cells * sizeof(Cell)),
        (const char *)proofs_bytes, (Py_ssize_t)(num_cells * 48),
        (unsigned long long)num_cells, h);
    return call_flag_out("verify_cell_kzg_proof_batch", args, ok);
}

}  // extern "C"
