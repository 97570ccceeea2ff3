/* _siddhi_torch_native — C hot path for host-side event marshalling of
 * siddhi_tpu_torch (its own copy of the JAX package's native/columnar.c
 * encoder and decoder, under a module name of its own).
 *
 * The device path is PyTorch + CUDA; the host runtime around it (ingestion
 * marshalling, string interning, Event construction on decode) is native:
 *
 *   encode_rows    Python row tuples -> pre-allocated columnar numpy
 *                  buffers (buffer protocol, no numpy C-API), interning
 *                  strings through the SAME dict/list pair that backs the
 *                  Python StringTable, so both paths share one code space;
 *   idmemo_new,    vectorized interning of one string column, with a
 *   intern_column  pointer-identity memo for producers that pool strings;
 *   map_codes      int32 codes -> list of strings;
 *   build_events   decoded columns -> list of Event objects.
 *
 * Type codes (one byte per attribute):
 *   'b' bool -> int8 buffer      'i' int -> int32
 *   'l' long -> int64            'f' float -> float32
 *   'd' double -> float64        's' string -> int32 (interned code)
 *
 * siddhi_tpu_torch/native.py builds this at first use with the host C
 * compiler; without one the Python encoder runs instead.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

/* Intern one string through (to_code: dict, to_str: list); returns code or -1
 * on error. None encodes as 0 (null). `transient` (may be NULL) is the
 * StringTable's transient-code dict: a LIVE transient string (a uuid coming
 * back from a client) must round-trip to its transient code, or device
 * equality against stored uuid columns would never match — and permanently
 * interning it would shadow the transient code for every later encode(). */
static int32_t
intern_string(PyObject *value, PyObject *to_code, PyObject *to_str,
              PyObject *transient)
{
    if (value == Py_None)
        return 0;
    PyObject *existing = PyDict_GetItemWithError(to_code, value);
    if (existing != NULL)
        return (int32_t)PyLong_AsLong(existing);
    if (PyErr_Occurred())
        return -1;
    if (transient != NULL && transient != Py_None) {
        existing = PyDict_GetItemWithError(transient, value);
        if (existing != NULL)
            return (int32_t)PyLong_AsLong(existing);
        if (PyErr_Occurred())
            return -1;
    }
    Py_ssize_t code = PyList_GET_SIZE(to_str);
    PyObject *code_obj = PyLong_FromSsize_t(code);
    if (code_obj == NULL)
        return -1;
    if (PyDict_SetItem(to_code, value, code_obj) < 0 ||
        PyList_Append(to_str, value) < 0) {
        Py_DECREF(code_obj);
        return -1;
    }
    Py_DECREF(code_obj);
    return (int32_t)code;
}

/* encode_rows(rows, typecodes: bytes, columns: tuple[memoryview-able],
 *             tables: tuple[(dict, list) | None], nulls: tuple[float|int]) */
static PyObject *
encode_rows(PyObject *self, PyObject *args)
{
    PyObject *rows, *typecodes_obj, *columns, *tables, *nulls;
    if (!PyArg_ParseTuple(args, "OSOOO", &rows, &typecodes_obj, &columns,
                          &tables, &nulls))
        return NULL;

    const char *typecodes = PyBytes_AS_STRING(typecodes_obj);
    Py_ssize_t n_cols = PyBytes_GET_SIZE(typecodes_obj);

    if (!PyTuple_Check(columns) || PyTuple_GET_SIZE(columns) < n_cols ||
        !PyTuple_Check(tables) || PyTuple_GET_SIZE(tables) < n_cols ||
        !PyTuple_Check(nulls) || PyTuple_GET_SIZE(nulls) < n_cols) {
        PyErr_SetString(PyExc_TypeError,
                        "columns/tables/nulls must be tuples of arity >= "
                        "len(typecodes)");
        return NULL;
    }

    PyObject *rows_fast = PySequence_Fast(rows, "rows must be a sequence");
    if (rows_fast == NULL)
        return NULL;
    Py_ssize_t n_rows = PySequence_Fast_GET_SIZE(rows_fast);

    /* acquire writable buffers for every column */
    Py_buffer *bufs = PyMem_Calloc((size_t)n_cols, sizeof(Py_buffer));
    if (bufs == NULL) {
        Py_DECREF(rows_fast);
        return PyErr_NoMemory();
    }
    Py_ssize_t acquired = 0;
    PyObject *result = NULL;
    for (; acquired < n_cols; acquired++) {
        PyObject *col = PyTuple_GET_ITEM(columns, acquired);
        if (PyObject_GetBuffer(col, &bufs[acquired],
                               PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
            goto done;
        /* capacity check: a short buffer would mean silent heap corruption
         * where the pure-Python fallback raises IndexError */
        static const Py_ssize_t width[128] = {
            ['b'] = 1, ['i'] = 4, ['l'] = 8, ['f'] = 4, ['d'] = 8, ['s'] = 4};
        char tc = typecodes[acquired];
        Py_ssize_t w = ((unsigned char)tc < 128) ? width[(int)tc] : 0;
        if (w == 0) {
            PyErr_Format(PyExc_ValueError, "bad type code %c", tc);
            acquired++; /* this buffer was acquired; release it in done */
            goto done;
        }
        if (bufs[acquired].len < n_rows * w) {
            PyErr_Format(PyExc_ValueError,
                         "column %zd buffer too small: %zd bytes for %zd "
                         "rows of width %zd", acquired, bufs[acquired].len,
                         n_rows, w);
            acquired++;
            goto done;
        }
        if (tc == 's') {
            PyObject *pair = PyTuple_GET_ITEM(tables, acquired);
            if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) < 2 ||
                PyTuple_GET_SIZE(pair) > 3 ||
                !PyDict_Check(PyTuple_GET_ITEM(pair, 0)) ||
                !PyList_Check(PyTuple_GET_ITEM(pair, 1)) ||
                (PyTuple_GET_SIZE(pair) == 3 &&
                 !PyDict_Check(PyTuple_GET_ITEM(pair, 2)))) {
                PyErr_Format(PyExc_TypeError,
                             "tables[%zd] must be (dict, list[, transient "
                             "dict]) for a string column", acquired);
                acquired++;
                goto done;
            }
        }
    }

    for (Py_ssize_t r = 0; r < n_rows; r++) {
        PyObject *row = PySequence_Fast_GET_ITEM(rows_fast, r);
        PyObject *row_fast = PySequence_Fast(row, "row must be a sequence");
        if (row_fast == NULL)
            goto done;
        if (PySequence_Fast_GET_SIZE(row_fast) < n_cols) {
            Py_DECREF(row_fast);
            PyErr_Format(PyExc_ValueError,
                         "row %zd has fewer than %zd values", r, n_cols);
            goto done;
        }
        for (Py_ssize_t c = 0; c < n_cols; c++) {
            PyObject *v = PySequence_Fast_GET_ITEM(row_fast, c);
            void *data = bufs[c].buf;
            char tc = typecodes[c];
            if (tc == 's') {
                PyObject *pair = PyTuple_GET_ITEM(tables, c);
                int32_t code = intern_string(
                    v, PyTuple_GET_ITEM(pair, 0), PyTuple_GET_ITEM(pair, 1),
                    PyTuple_GET_SIZE(pair) == 3 ? PyTuple_GET_ITEM(pair, 2)
                                                : NULL);
                if (code < 0 && PyErr_Occurred()) {
                    Py_DECREF(row_fast);
                    goto done;
                }
                ((int32_t *)data)[r] = code;
                continue;
            }
            int is_null = (v == Py_None);
            if (is_null)
                v = PyTuple_GET_ITEM(nulls, c);
            switch (tc) {
            case 'b': {
                int x = PyObject_IsTrue(v);
                if (x < 0) { Py_DECREF(row_fast); goto done; }
                ((int8_t *)data)[r] = (int8_t)x;
                break;
            }
            case 'i': {
                long x = PyLong_AsLong(v);
                if (x == -1 && PyErr_Occurred()) { Py_DECREF(row_fast); goto done; }
                ((int32_t *)data)[r] = (int32_t)x;
                break;
            }
            case 'l': {
                long long x = PyLong_AsLongLong(v);
                if (x == -1 && PyErr_Occurred()) { Py_DECREF(row_fast); goto done; }
                ((int64_t *)data)[r] = (int64_t)x;
                break;
            }
            case 'f': {
                double x = PyFloat_AsDouble(v);
                if (x == -1.0 && PyErr_Occurred()) { Py_DECREF(row_fast); goto done; }
                ((float *)data)[r] = (float)x;
                break;
            }
            case 'd': {
                double x = PyFloat_AsDouble(v);
                if (x == -1.0 && PyErr_Occurred()) { Py_DECREF(row_fast); goto done; }
                ((double *)data)[r] = x;
                break;
            }
            default:
                Py_DECREF(row_fast);
                PyErr_Format(PyExc_ValueError, "bad type code %c", tc);
                goto done;
            }
        }
        Py_DECREF(row_fast);
    }
    result = Py_NewRef(Py_None);

done:
    for (Py_ssize_t i = 0; i < acquired; i++)
        PyBuffer_Release(&bufs[i]);
    PyMem_Free(bufs);
    Py_DECREF(rows_fast);
    return result;
}

/* --- pointer-identity intern memo -------------------------------------
 *
 * Producers that pool their string objects (a symbol universe, a parsed
 * dictionary — the common shape for market-data/telemetry feeds) send the
 * SAME PyObject* for a value over and over. A bounded open-addressing map
 * keyed on object identity turns the per-value PyDict_GetItem (hash every
 * character) into a pointer compare (~4 ns). Entries hold STRONG refs, so
 * a pointer can never be recycled for a different string while memoized;
 * only PERMANENT codes are memoized (append-only, never reassigned) —
 * transient uuid-ring codes recycle and must not be cached. The memo is
 * dropped wholesale on StringTable.restore (codes reassigned there). */

#define IDMEMO_BITS 13
#define IDMEMO_SIZE (1 << IDMEMO_BITS)  /* 8192 slots/attr, ~96 KB */

typedef struct {
    PyObject *keys[IDMEMO_SIZE]; /* strong refs or NULL */
    int32_t codes[IDMEMO_SIZE];
} id_memo;

static void
idmemo_capsule_destruct(PyObject *capsule)
{
    id_memo *m = (id_memo *)PyCapsule_GetPointer(capsule, "siddhi.idmemo");
    if (m == NULL)
        return;
    for (Py_ssize_t i = 0; i < IDMEMO_SIZE; i++)
        Py_XDECREF(m->keys[i]);
    PyMem_Free(m);
}

/* idmemo_new() -> capsule */
static PyObject *
idmemo_new(PyObject *self, PyObject *args)
{
    id_memo *m = PyMem_Calloc(1, sizeof(id_memo));
    if (m == NULL)
        return PyErr_NoMemory();
    return PyCapsule_New(m, "siddhi.idmemo", idmemo_capsule_destruct);
}

static inline size_t
idmemo_slot(PyObject *p)
{
    /* low bits of the pointer are alignment zeros; Fibonacci-mix the rest */
    return (size_t)(((uintptr_t)p >> 4) * (uintptr_t)0x9E3779B97F4A7C15ULL
                    >> (64 - IDMEMO_BITS));
}

/* intern_column(values, out: int32 buffer, to_code: dict, to_str: list,
 *               transient: dict[, memo_capsule]) — vectorized string
 * interning for one column (send_columns path); `transient` keeps live
 * uuid codes stable. */
static PyObject *
intern_column(PyObject *self, PyObject *args)
{
    PyObject *values, *out, *to_code, *to_str, *transient;
    PyObject *memo_capsule = NULL;
    if (!PyArg_ParseTuple(args, "OOO!O!O!|O", &values, &out,
                          &PyDict_Type, &to_code, &PyList_Type, &to_str,
                          &PyDict_Type, &transient, &memo_capsule))
        return NULL;
    id_memo *memo = NULL;
    if (memo_capsule != NULL && memo_capsule != Py_None) {
        memo = (id_memo *)PyCapsule_GetPointer(memo_capsule,
                                               "siddhi.idmemo");
        if (memo == NULL)
            return NULL;
    }
    PyObject *fast = PySequence_Fast(values, "values must be a sequence");
    if (fast == NULL)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    Py_buffer buf;
    if (PyObject_GetBuffer(out, &buf, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
        Py_DECREF(fast);
        return NULL;
    }
    if (buf.len < n * (Py_ssize_t)sizeof(int32_t)) {
        PyErr_SetString(PyExc_ValueError, "intern_column: out buffer too small");
        PyBuffer_Release(&buf);
        Py_DECREF(fast);
        return NULL;
    }
    int32_t *data = (int32_t *)buf.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = PySequence_Fast_GET_ITEM(fast, i);
        size_t slot = 0, slot2 = 0;
        if (memo != NULL && v != Py_None) {
            slot = idmemo_slot(v);
            if (memo->keys[slot] == v) {
                data[i] = memo->codes[slot];
                continue;
            }
            slot2 = (slot + 1) & (IDMEMO_SIZE - 1); /* one probe step */
            if (memo->keys[slot2] == v) {
                data[i] = memo->codes[slot2];
                continue;
            }
        }
        int32_t code = intern_string(v, to_code, to_str, transient);
        if (code < 0 && PyErr_Occurred()) {
            PyBuffer_Release(&buf);
            Py_DECREF(fast);
            return NULL;
        }
        data[i] = code;
        /* memoize permanent codes only (transient ring codes recycle);
         * prefer an empty slot, else evict the probe slot */
        if (memo != NULL && v != Py_None && code < (1 << 30)) {
            size_t s = (memo->keys[slot] == NULL) ? slot : slot2;
            Py_XDECREF(memo->keys[s]);
            Py_INCREF(v);
            memo->keys[s] = v;
            memo->codes[s] = code;
        }
    }
    PyBuffer_Release(&buf);
    Py_DECREF(fast);
    return Py_NewRef(Py_None);
}

/* map_codes(codes: int32 buffer, to_str: list) -> list[str|None]
 * — vectorized string-column decode; out-of-range codes map to None (the
 *   caller pre-screens transient codes and takes the Python path). */
static PyObject *
map_codes(PyObject *self, PyObject *args)
{
    PyObject *codes, *to_str;
    if (!PyArg_ParseTuple(args, "OO!", &codes, &PyList_Type, &to_str))
        return NULL;
    Py_buffer buf;
    if (PyObject_GetBuffer(codes, &buf, PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    Py_ssize_t n = buf.len / (Py_ssize_t)sizeof(int32_t);
    Py_ssize_t table_n = PyList_GET_SIZE(to_str);
    const int32_t *data = (const int32_t *)buf.buf;
    PyObject *result = PyList_New(n);
    if (result == NULL) {
        PyBuffer_Release(&buf);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        int32_t c = data[i];
        PyObject *v = (c >= 0 && c < table_n) ? PyList_GET_ITEM(to_str, c)
                                              : Py_None;
        PyList_SET_ITEM(result, i, Py_NewRef(v));
    }
    PyBuffer_Release(&buf);
    return result;
}

/* build_events(event_cls, ts: int64 buffer, expired: uint8 buffer,
 *              cols: tuple[list]) -> list[Event]
 *
 * Decode hot loop: allocates Event instances via tp_alloc and fills the
 * three fields through their (pre-fetched) slot descriptors — bypassing
 * __init__ cuts per-event cost ~5x, which is the difference between the
 * public callback path keeping up with the device and not. */
static PyObject *
build_events(PyObject *self, PyObject *args)
{
    PyObject *cls_obj, *ts_obj, *exp_obj, *cols;
    if (!PyArg_ParseTuple(args, "OOOO!", &cls_obj, &ts_obj, &exp_obj,
                          &PyTuple_Type, &cols))
        return NULL;
    if (!PyType_Check(cls_obj)) {
        PyErr_SetString(PyExc_TypeError, "event_cls must be a type");
        return NULL;
    }
    PyTypeObject *cls = (PyTypeObject *)cls_obj;
    Py_ssize_t n_cols = PyTuple_GET_SIZE(cols);

    Py_buffer ts_buf, exp_buf;
    if (PyObject_GetBuffer(ts_obj, &ts_buf, PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (PyObject_GetBuffer(exp_obj, &exp_buf, PyBUF_C_CONTIGUOUS) < 0) {
        PyBuffer_Release(&ts_buf);
        return NULL;
    }
    Py_ssize_t n = ts_buf.len / (Py_ssize_t)sizeof(int64_t);
    PyObject *result = NULL, *d_ts = NULL, *d_data = NULL, *d_exp = NULL;
    if (exp_buf.len < n) {
        PyErr_SetString(PyExc_ValueError, "expired buffer shorter than ts");
        goto fail;
    }
    for (Py_ssize_t c = 0; c < n_cols; c++) {
        PyObject *col = PyTuple_GET_ITEM(cols, c);
        if (!PyList_Check(col) || PyList_GET_SIZE(col) < n) {
            PyErr_Format(PyExc_ValueError,
                         "cols[%zd] must be a list of >= %zd items", c, n);
            goto fail;
        }
    }
    d_ts = PyObject_GetAttrString(cls_obj, "timestamp");
    d_data = PyObject_GetAttrString(cls_obj, "data");
    d_exp = PyObject_GetAttrString(cls_obj, "is_expired");
    if (!d_ts || !d_data || !d_exp)
        goto fail;
    descrsetfunc set_ts = Py_TYPE(d_ts)->tp_descr_set;
    descrsetfunc set_data = Py_TYPE(d_data)->tp_descr_set;
    descrsetfunc set_exp = Py_TYPE(d_exp)->tp_descr_set;
    if (!set_ts || !set_data || !set_exp) {
        PyErr_SetString(PyExc_TypeError,
                        "event_cls fields must be slot descriptors");
        goto fail;
    }
    const int64_t *ts_data = (const int64_t *)ts_buf.buf;
    const uint8_t *exp_data = (const uint8_t *)exp_buf.buf;

    result = PyList_New(n);
    if (result == NULL)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *data = PyTuple_New(n_cols);
        if (data == NULL)
            goto fail_clear;
        for (Py_ssize_t c = 0; c < n_cols; c++) {
            PyObject *v = PyList_GET_ITEM(PyTuple_GET_ITEM(cols, c), i);
            PyTuple_SET_ITEM(data, c, Py_NewRef(v));
        }
        PyObject *ev = cls->tp_alloc(cls, 0);
        if (ev == NULL) {
            Py_DECREF(data);
            goto fail_clear;
        }
        PyObject *ts_val = PyLong_FromLongLong((long long)ts_data[i]);
        if (ts_val == NULL ||
            set_ts(d_ts, ev, ts_val) < 0 ||
            set_data(d_data, ev, data) < 0 ||
            set_exp(d_exp, ev, exp_data[i] ? Py_True : Py_False) < 0) {
            Py_XDECREF(ts_val);
            Py_DECREF(data);
            Py_DECREF(ev);
            goto fail_clear;
        }
        Py_DECREF(ts_val);
        Py_DECREF(data); /* slot holds its own reference */
        /* untrack from the cyclic GC: events hold only a tuple of scalars /
         * strings (no cycles possible), and tracking millions of short-lived
         * objects makes gen-0 collections the decode bottleneck */
        if (PyObject_GC_IsTracked(data))
            PyObject_GC_UnTrack(data);
        if (PyObject_GC_IsTracked(ev))
            PyObject_GC_UnTrack(ev);
        PyList_SET_ITEM(result, i, ev);
    }
    goto done;

fail_clear:
    Py_CLEAR(result);
fail:
done:
    Py_XDECREF(d_ts);
    Py_XDECREF(d_data);
    Py_XDECREF(d_exp);
    PyBuffer_Release(&ts_buf);
    PyBuffer_Release(&exp_buf);
    return result;
}

static PyMethodDef methods[] = {
    {"encode_rows", encode_rows, METH_VARARGS,
     "Encode row tuples into pre-allocated column buffers."},
    {"idmemo_new", idmemo_new, METH_VARARGS,
     "idmemo_new() -> capsule: pointer-identity intern memo"},
    {"intern_column", intern_column, METH_VARARGS,
     "Intern a string column into an int32 code buffer."},
    {"map_codes", map_codes, METH_VARARGS,
     "Decode an int32 code buffer through a string table list."},
    {"build_events", build_events, METH_VARARGS,
     "Construct a list of Event objects from decoded columns."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_siddhi_torch_native",
    "Native host-path marshalling for siddhi_tpu_torch.", -1, methods,
};

PyMODINIT_FUNC
PyInit__siddhi_torch_native(void)
{
    return PyModule_Create(&module);
}
