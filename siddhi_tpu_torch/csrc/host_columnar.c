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
 *   build_events   decoded columns -> list of Event objects;
 *   ring_*         the MPSC row staging ring of an @Async junction;
 *   colring_*      the lock-free columnar ring of the parallel ingress
 *                  pipeline (claim a run, write it with the GIL released,
 *                  one consumer pops contiguous published runs).
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

/* ------------------------------------------------------------------------
 * MPSC staging ring — the Disruptor's role (reference:
 * core/stream/StreamJunction.java:279-316 ring buffer + worker consumers).
 *
 * Producers (source threads / user send) claim slots with a C11 atomic
 * fetch-add and publish with a per-slot sequence stamp; one consumer (the
 * junction's feeder thread) drains batches. Correct for true concurrent
 * producers (the design does not lean on the GIL for the index protocol;
 * the PyObject* payloads themselves are only touched under the GIL, which
 * every Python-level producer and the feeder hold at the call boundary).
 * ---------------------------------------------------------------------- */

#include <stdatomic.h>

#include <stddef.h>

/* The columnar ring's claim/publish/consume protocol (the port's own
 * copy of the JAX package's colring_core.h): Disruptor-style multi-
 * producer, single consumer. Producers claim a contiguous run with ONE
 * CAS on `head` (claim order IS delivery order); each slot is published
 * by a release store of index + 1 into its cache-line-padded seq entry
 * after the payload is written; the consumer counts the contiguous
 * published prefix with acquire loads, copies out, then retires the
 * run (relaxed seq resets, a release store of the tail). */


/* Slot sequence entries are cache-line padded: adjacent slots are
 * published by different producer threads, and false sharing on the seq
 * array is the classic scalability cliff for exactly this structure. */
typedef struct {
    atomic_size_t v;
    char pad[64 - sizeof(atomic_size_t)];
} crc_seq;

typedef struct {
    size_t cap;               /* power of two */
    size_t mask;
    crc_seq *seq;             /* published when seq[i & mask].v == i + 1 */
    atomic_size_t head;       /* next slot to claim (producers, CAS) */
    char pad1[64 - sizeof(atomic_size_t)];
    atomic_size_t tail;       /* next slot to read (single consumer) */
    char pad2[64 - sizeof(atomic_size_t)];
    atomic_size_t hwm;        /* claimed-depth high-water mark */
} crc_ring;

/* cap must be a power of two; seq must hold cap zero-initialised entries
 * and stay alive as long as the ring. */
static inline void
crc_init(crc_ring *r, crc_seq *seq, size_t cap)
{
    r->cap = cap;
    r->mask = cap - 1;
    r->seq = seq;
    atomic_init(&r->head, 0);
    atomic_init(&r->tail, 0);
    atomic_init(&r->hwm, 0);
}

/* Claim n contiguous slots; returns the start index, or -1 when the ring
 * lacks n free slots (all-or-nothing; the caller spins/backpressures).
 * The successful CAS is acq_rel: the acquire half orders the claim after
 * the tail observation, the release half makes the claim visible before
 * any payload store the producer issues next. */
static inline ptrdiff_t
crc_claim(crc_ring *r, size_t n)
{
    size_t h = atomic_load_explicit(&r->head, memory_order_relaxed);
    for (;;) {
        size_t t = atomic_load_explicit(&r->tail, memory_order_acquire);
        if (h + n - t > r->cap)
            return -1; /* insufficient free space */
        if (atomic_compare_exchange_weak_explicit(
                &r->head, &h, h + n,
                memory_order_acq_rel, memory_order_relaxed)) {
            size_t depth = h + n - t;
            size_t hwm = atomic_load_explicit(&r->hwm, memory_order_relaxed);
            while (depth > hwm &&
                   !atomic_compare_exchange_weak_explicit(
                       &r->hwm, &hwm, depth,
                       memory_order_relaxed, memory_order_relaxed))
                ;
            return (ptrdiff_t)h;
        }
    }
}

/* Publish one claimed run. MUST run after the payload for [start,
 * start + n) is fully written: the per-slot release stores are what make
 * those plain payload writes visible to the consumer's acquire loads. */
static inline void
crc_publish(crc_ring *r, size_t start, size_t n)
{
    for (size_t i = 0; i < n; i++)
        atomic_store_explicit(&r->seq[(start + i) & r->mask].v,
                              start + i + 1, memory_order_release);
}

/* Single consumer: length of the contiguous published prefix at the
 * current tail, capped at max_n. After this returns k, the payload of
 * slots [tail, tail + k) is safe to read (acquire loads above). */
static inline size_t
crc_poll(crc_ring *r, size_t max_n)
{
    size_t t = atomic_load_explicit(&r->tail, memory_order_relaxed);
    size_t n = 0;
    while (n < max_n &&
           atomic_load_explicit(&r->seq[(t + n) & r->mask].v,
                                memory_order_acquire) == t + n + 1)
        n++;
    return n;
}

/* Single consumer: retire n slots previously returned by crc_poll. Seq
 * resets can be relaxed — a producer only reuses a slot after observing
 * the released tail bump, which orders the reset before the reuse. */
static inline void
crc_consume(crc_ring *r, size_t n)
{
    size_t t = atomic_load_explicit(&r->tail, memory_order_relaxed);
    for (size_t i = 0; i < n; i++)
        atomic_store_explicit(&r->seq[(t + i) & r->mask].v, 0,
                              memory_order_relaxed);
    atomic_store_explicit(&r->tail, t + n, memory_order_release);
}

/* Claimed, unconsumed depth (approximate under concurrent producers;
 * includes claimed-but-unwritten runs). */
static inline size_t
crc_size(const crc_ring *r)
{
    return atomic_load_explicit(&((crc_ring *)r)->head,
                                memory_order_relaxed) -
           atomic_load_explicit(&((crc_ring *)r)->tail,
                                memory_order_relaxed);
}

static inline size_t
crc_hwm(const crc_ring *r)
{
    return atomic_load_explicit(&((crc_ring *)r)->hwm,
                                memory_order_relaxed);
}

typedef struct {
    Py_ssize_t cap;
    atomic_size_t head;       /* next slot to claim (producers) */
    size_t tail;              /* next slot to read (single consumer) */
    atomic_size_t *seq;       /* published when seq[i % cap] == i + 1 */
    PyObject **rows;          /* owned references */
    int64_t *ts;
} mpsc_ring;

static void
ring_capsule_destruct(PyObject *capsule)
{
    mpsc_ring *r = (mpsc_ring *)PyCapsule_GetPointer(capsule, "siddhi.ring");
    if (r == NULL)
        return;
    for (size_t i = r->tail; i < atomic_load(&r->head); i++) {
        size_t s = i % (size_t)r->cap;
        if (atomic_load(&r->seq[s]) == i + 1)
            Py_XDECREF(r->rows[s]);
    }
    PyMem_Free(r->seq);
    PyMem_Free(r->rows);
    PyMem_Free(r->ts);
    PyMem_Free(r);
}

/* ring_new(capacity) -> capsule */
static PyObject *
ring_new(PyObject *self, PyObject *args)
{
    Py_ssize_t cap;
    if (!PyArg_ParseTuple(args, "n", &cap))
        return NULL;
    if (cap < 1) {
        PyErr_SetString(PyExc_ValueError, "ring capacity must be >= 1");
        return NULL;
    }
    mpsc_ring *r = PyMem_Calloc(1, sizeof(mpsc_ring));
    if (r == NULL)
        return PyErr_NoMemory();
    r->cap = cap;
    atomic_init(&r->head, 0);
    r->tail = 0;
    r->seq = PyMem_Calloc((size_t)cap, sizeof(atomic_size_t));
    r->rows = PyMem_Calloc((size_t)cap, sizeof(PyObject *));
    r->ts = PyMem_Calloc((size_t)cap, sizeof(int64_t));
    if (!r->seq || !r->rows || !r->ts) {
        PyMem_Free(r->seq); PyMem_Free(r->rows); PyMem_Free(r->ts);
        PyMem_Free(r);
        return PyErr_NoMemory();
    }
    return PyCapsule_New(r, "siddhi.ring", ring_capsule_destruct);
}

static mpsc_ring *
ring_of(PyObject *capsule)
{
    return (mpsc_ring *)PyCapsule_GetPointer(capsule, "siddhi.ring");
}

/* ring_push(ring, ts, row) -> bool (False = full, caller applies
 * backpressure like the Disruptor's blocking wait) */
static PyObject *
ring_push(PyObject *self, PyObject *args)
{
    PyObject *capsule, *row;
    long long ts;
    if (!PyArg_ParseTuple(args, "OLO", &capsule, &ts, &row))
        return NULL;
    mpsc_ring *r = ring_of(capsule);
    if (r == NULL)
        return NULL;
    size_t cap = (size_t)r->cap;
    size_t claimed = atomic_load(&r->head);
    for (;;) {
        if (claimed - r->tail >= cap)
            Py_RETURN_FALSE; /* full */
        if (atomic_compare_exchange_weak(&r->head, &claimed, claimed + 1))
            break;
    }
    size_t s = claimed % cap;
    Py_INCREF(row);
    r->rows[s] = row;
    r->ts[s] = (int64_t)ts;
    atomic_store(&r->seq[s], claimed + 1); /* publish */
    Py_RETURN_TRUE;
}

/* ring_pop_batch(ring, max_n) -> (ts_list, row_list) — single consumer */
static PyObject *
ring_pop_batch(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    Py_ssize_t max_n;
    if (!PyArg_ParseTuple(args, "On", &capsule, &max_n))
        return NULL;
    mpsc_ring *r = ring_of(capsule);
    if (r == NULL)
        return NULL;
    PyObject *ts_list = PyList_New(0);
    PyObject *row_list = PyList_New(0);
    if (!ts_list || !row_list) {
        Py_XDECREF(ts_list);
        Py_XDECREF(row_list);
        return NULL;
    }
    size_t cap = (size_t)r->cap;
    for (Py_ssize_t n = 0; n < max_n; n++) {
        size_t i = r->tail;
        size_t s = i % cap;
        if (atomic_load(&r->seq[s]) != i + 1)
            break; /* not yet published (or empty) */
        PyObject *ts_obj = PyLong_FromLongLong((long long)r->ts[s]);
        if (ts_obj == NULL || PyList_Append(ts_list, ts_obj) < 0 ||
            PyList_Append(row_list, r->rows[s]) < 0) {
            Py_XDECREF(ts_obj);
            Py_DECREF(ts_list);
            Py_DECREF(row_list);
            return NULL;
        }
        Py_DECREF(ts_obj);
        Py_DECREF(r->rows[s]);
        r->rows[s] = NULL;
        atomic_store(&r->seq[s], 0);
        r->tail = i + 1;
    }
    return Py_BuildValue("(NN)", ts_list, row_list);
}

/* ring_size(ring) -> int (published, unconsumed entries; approximate
 * under concurrent producers) */
static PyObject *
ring_size(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    if (!PyArg_ParseTuple(args, "O", &capsule))
        return NULL;
    mpsc_ring *r = ring_of(capsule);
    if (r == NULL)
        return NULL;
    return PyLong_FromSize_t(atomic_load(&r->head) - r->tail);
}

/* ------------------------------------------------------------------------
 * Lock-free multi-producer COLUMNAR ring — the zero-copy ingress stage.
 *
 * Where the MPSC ring above stages PyObject* rows (decoded under the GIL by
 * the feeder), this ring stages raw columnar bytes: fixed-width native
 * buffers, one per attribute (string attrs as pre-interned int32 dictionary
 * codes). Producers claim a contiguous run of slots with one CAS
 * (claim-then-write, Disruptor-style, so parallel encode workers can fill
 * their runs out of order while consumption stays in claim order), write
 * with the GIL RELEASED (the payload is plain memory — memcpy needs no
 * interpreter), and publish per-slot sequence stamps. One consumer copies
 * contiguous published runs out into caller buffers, also without the GIL.
 *
 * The claim/publish/consume protocol is the crc_* functions above; these
 * wrappers own arg parsing, Py_buffer handling, payload memcpy, and the
 * GIL.
 * ---------------------------------------------------------------------- */

#define COLRING_MAX_COLS 64

typedef struct {
    crc_ring rc;              /* claim/publish protocol (crc_* above) */
    int n_cols;
    Py_ssize_t widths[COLRING_MAX_COLS];
    char *cols[COLRING_MAX_COLS];   /* cap * width bytes each */
    int64_t *ts;
} colring;

static void
colring_capsule_destruct(PyObject *capsule)
{
    colring *r = (colring *)PyCapsule_GetPointer(capsule, "siddhi.colring");
    if (r == NULL)
        return;
    for (int c = 0; c < r->n_cols; c++)
        PyMem_Free(r->cols[c]);
    PyMem_Free(r->ts);
    PyMem_Free(r->rc.seq);
    PyMem_Free(r);
}

static Py_ssize_t
colring_width(char tc)
{
    switch (tc) {
    case 'b': return 1;
    case 'i': return 4;
    case 'l': return 8;
    case 'f': return 4;
    case 'd': return 8;
    case 's': return 4;  /* pre-interned int32 dictionary codes */
    default:  return 0;
    }
}

/* colring_new(capacity, typecodes: bytes) -> capsule */
static PyObject *
colring_new(PyObject *self, PyObject *args)
{
    Py_ssize_t cap_req;
    PyObject *typecodes_obj;
    if (!PyArg_ParseTuple(args, "nS", &cap_req, &typecodes_obj))
        return NULL;
    if (cap_req < 1) {
        PyErr_SetString(PyExc_ValueError, "colring capacity must be >= 1");
        return NULL;
    }
    Py_ssize_t n_cols = PyBytes_GET_SIZE(typecodes_obj);
    if (n_cols > COLRING_MAX_COLS) {
        PyErr_Format(PyExc_ValueError, "colring supports at most %d columns",
                     COLRING_MAX_COLS);
        return NULL;
    }
    size_t cap = 1;
    while (cap < (size_t)cap_req)
        cap <<= 1;
    colring *r = PyMem_Calloc(1, sizeof(colring));
    if (r == NULL)
        return PyErr_NoMemory();
    r->n_cols = (int)n_cols;
    const char *tcs = PyBytes_AS_STRING(typecodes_obj);
    r->ts = PyMem_Malloc(cap * sizeof(int64_t));
    crc_init(&r->rc, PyMem_Calloc(cap, sizeof(crc_seq)), cap);
    if (r->ts == NULL || r->rc.seq == NULL) {
        PyErr_NoMemory();
        goto fail;
    }
    for (Py_ssize_t c = 0; c < n_cols; c++) {
        Py_ssize_t w = colring_width(tcs[c]);
        if (w == 0) {
            PyErr_Format(PyExc_ValueError, "bad type code %c", tcs[c]);
            goto fail;
        }
        r->widths[c] = w;
        r->cols[c] = PyMem_Malloc(cap * (size_t)w);
        if (r->cols[c] == NULL) {
            PyErr_NoMemory();
            goto fail;
        }
    }
    return PyCapsule_New(r, "siddhi.colring", colring_capsule_destruct);

fail:
    for (Py_ssize_t k = 0; k < n_cols; k++)
        PyMem_Free(r->cols[k]);  /* calloc'd struct: unset slots are NULL */
    PyMem_Free(r->ts);
    PyMem_Free(r->rc.seq);
    PyMem_Free(r);
    return NULL;
}

static colring *
colring_of(PyObject *capsule)
{
    return (colring *)PyCapsule_GetPointer(capsule, "siddhi.colring");
}

/* colring_claim(ring, n) -> start index, or -1 when the ring lacks n free
 * slots (all-or-nothing; the caller spins/backpressures). One CAS claims
 * the whole contiguous run — claim order IS delivery order, which is what
 * makes parallel out-of-order encode workers deterministic downstream. */
static PyObject *
colring_claim(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "On", &capsule, &n))
        return NULL;
    colring *r = colring_of(capsule);
    if (r == NULL)
        return NULL;
    if (n < 1 || (size_t)n > r->rc.cap) {
        PyErr_Format(PyExc_ValueError,
                     "colring_claim: n=%zd out of range (cap %zu)",
                     n, r->rc.cap);
        return NULL;
    }
    ptrdiff_t start = crc_claim(&r->rc, (size_t)n);
    if (start < 0)
        return PyLong_FromLong(-1); /* insufficient free space */
    return PyLong_FromUnsignedLongLong((unsigned long long)start);
}

/* colring_write(ring, start, n, ts_buf: int64[n], cols: tuple[buffer]) —
 * copy one claimed run into the ring and publish it. The copies run with
 * the GIL released; string columns arrive here already interned to int32
 * codes (interning is the only stage that still batch-acquires the GIL,
 * in the worker pool above this). */
static PyObject *
colring_write(PyObject *self, PyObject *args)
{
    PyObject *capsule, *ts_obj, *cols;
    unsigned long long start;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "OKnOO!", &capsule, &start, &n, &ts_obj,
                          &PyTuple_Type, &cols))
        return NULL;
    colring *r = colring_of(capsule);
    if (r == NULL)
        return NULL;
    if (PyTuple_GET_SIZE(cols) != r->n_cols) {
        PyErr_Format(PyExc_ValueError, "colring_write: expected %d columns",
                     r->n_cols);
        return NULL;
    }
    Py_buffer ts_buf;
    Py_buffer bufs[COLRING_MAX_COLS];
    if (PyObject_GetBuffer(ts_obj, &ts_buf, PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    if (ts_buf.len < n * (Py_ssize_t)sizeof(int64_t)) {
        PyErr_SetString(PyExc_ValueError, "colring_write: ts buffer short");
        PyBuffer_Release(&ts_buf);
        return NULL;
    }
    int acquired = 0;
    for (; acquired < r->n_cols; acquired++) {
        if (PyObject_GetBuffer(PyTuple_GET_ITEM(cols, acquired),
                               &bufs[acquired], PyBUF_C_CONTIGUOUS) < 0)
            goto fail;
        if (bufs[acquired].len < n * r->widths[acquired]) {
            PyErr_Format(PyExc_ValueError,
                         "colring_write: column %d buffer short", acquired);
            acquired++;
            goto fail;
        }
    }
    Py_BEGIN_ALLOW_THREADS
    {
        size_t s0 = (size_t)start & r->rc.mask;
        size_t first = r->rc.cap - s0;       /* slots before wrap */
        if (first > (size_t)n)
            first = (size_t)n;
        size_t second = (size_t)n - first;
        memcpy(r->ts + s0, ts_buf.buf, first * sizeof(int64_t));
        if (second)
            memcpy(r->ts, (const int64_t *)ts_buf.buf + first,
                   second * sizeof(int64_t));
        for (int c = 0; c < r->n_cols; c++) {
            size_t w = (size_t)r->widths[c];
            const char *src = (const char *)bufs[c].buf;
            memcpy(r->cols[c] + s0 * w, src, first * w);
            if (second)
                memcpy(r->cols[c], src + first * w, second * w);
        }
        /* publish AFTER the data: crc_publish's release stores pair with
         * the consumer's acquire loads, slot by slot */
        crc_publish(&r->rc, (size_t)start, (size_t)n);
    }
    Py_END_ALLOW_THREADS
    for (int i = 0; i < acquired; i++)
        PyBuffer_Release(&bufs[i]);
    PyBuffer_Release(&ts_buf);
    Py_RETURN_NONE;

fail:
    for (int i = 0; i < acquired; i++)
        PyBuffer_Release(&bufs[i]);
    PyBuffer_Release(&ts_buf);
    return NULL;
}

/* colring_pop(ring, max_n, ts_out: int64 buffer, cols_out: tuple[buffer])
 * -> n copied (0 when nothing contiguous is published). Single consumer. */
static PyObject *
colring_pop(PyObject *self, PyObject *args)
{
    PyObject *capsule, *ts_obj, *cols;
    Py_ssize_t max_n;
    if (!PyArg_ParseTuple(args, "OnOO!", &capsule, &max_n, &ts_obj,
                          &PyTuple_Type, &cols))
        return NULL;
    colring *r = colring_of(capsule);
    if (r == NULL)
        return NULL;
    if (PyTuple_GET_SIZE(cols) != r->n_cols) {
        PyErr_Format(PyExc_ValueError, "colring_pop: expected %d columns",
                     r->n_cols);
        return NULL;
    }
    Py_buffer ts_buf;
    Py_buffer bufs[COLRING_MAX_COLS];
    if (PyObject_GetBuffer(ts_obj, &ts_buf,
                           PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
        return NULL;
    int acquired = 0;
    for (; acquired < r->n_cols; acquired++) {
        if (PyObject_GetBuffer(PyTuple_GET_ITEM(cols, acquired),
                               &bufs[acquired],
                               PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0)
            goto fail;
    }
    /* bound max_n by the output buffers up front */
    if (ts_buf.len / (Py_ssize_t)sizeof(int64_t) < max_n)
        max_n = ts_buf.len / (Py_ssize_t)sizeof(int64_t);
    for (int c = 0; c < r->n_cols; c++)
        if (bufs[c].len / r->widths[c] < max_n)
            max_n = bufs[c].len / r->widths[c];
    if (max_n < 0)
        max_n = 0;
    size_t n = crc_poll(&r->rc, (size_t)max_n);
    if (n > 0) {
        Py_BEGIN_ALLOW_THREADS
        {
            size_t t = atomic_load_explicit(&r->rc.tail,
                                            memory_order_relaxed);
            size_t s0 = t & r->rc.mask;
            size_t first = r->rc.cap - s0;
            if (first > n)
                first = n;
            size_t second = n - first;
            memcpy(ts_buf.buf, r->ts + s0, first * sizeof(int64_t));
            if (second)
                memcpy((int64_t *)ts_buf.buf + first, r->ts,
                       second * sizeof(int64_t));
            for (int c = 0; c < r->n_cols; c++) {
                size_t w = (size_t)r->widths[c];
                char *dst = (char *)bufs[c].buf;
                memcpy(dst, r->cols[c] + s0 * w, first * w);
                if (second)
                    memcpy(dst + first * w, r->cols[c], second * w);
            }
            crc_consume(&r->rc, n);
        }
        Py_END_ALLOW_THREADS
    }
    for (int i = 0; i < acquired; i++)
        PyBuffer_Release(&bufs[i]);
    PyBuffer_Release(&ts_buf);
    return PyLong_FromSize_t(n);

fail:
    for (int i = 0; i < acquired; i++)
        PyBuffer_Release(&bufs[i]);
    PyBuffer_Release(&ts_buf);
    return NULL;
}

/* colring_size(ring) -> claimed, unconsumed depth (approximate under
 * concurrent producers; includes claimed-but-unwritten runs) */
static PyObject *
colring_size(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    if (!PyArg_ParseTuple(args, "O", &capsule))
        return NULL;
    colring *r = colring_of(capsule);
    if (r == NULL)
        return NULL;
    return PyLong_FromSize_t(crc_size(&r->rc));
}

/* colring_capacity(ring) -> rounded power-of-two slot count */
static PyObject *
colring_capacity(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    if (!PyArg_ParseTuple(args, "O", &capsule))
        return NULL;
    colring *r = colring_of(capsule);
    if (r == NULL)
        return NULL;
    return PyLong_FromSize_t(r->rc.cap);
}

/* colring_hwm(ring) -> claimed-depth high-water mark over the ring's life */
static PyObject *
colring_hwm(PyObject *self, PyObject *args)
{
    PyObject *capsule;
    if (!PyArg_ParseTuple(args, "O", &capsule))
        return NULL;
    colring *r = colring_of(capsule);
    if (r == NULL)
        return NULL;
    return PyLong_FromSize_t(crc_hwm(&r->rc));
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
    {"ring_new", ring_new, METH_VARARGS,
     "ring_new(capacity) -> capsule: MPSC row staging ring"},
    {"ring_push", ring_push, METH_VARARGS,
     "ring_push(ring, ts, row) -> bool (False when full)"},
    {"ring_pop_batch", ring_pop_batch, METH_VARARGS,
     "ring_pop_batch(ring, max_n) -> (ts_list, row_list)"},
    {"ring_size", ring_size, METH_VARARGS,
     "ring_size(ring) -> published, unconsumed entries"},
    {"colring_new", colring_new, METH_VARARGS,
     "colring_new(capacity, typecodes) -> capsule: columnar ingress ring"},
    {"colring_claim", colring_claim, METH_VARARGS,
     "colring_claim(ring, n) -> start, or -1 when full"},
    {"colring_write", colring_write, METH_VARARGS,
     "colring_write(ring, start, n, ts, cols): copy a run and publish it"},
    {"colring_pop", colring_pop, METH_VARARGS,
     "colring_pop(ring, max_n, ts_out, cols_out) -> rows copied"},
    {"colring_size", colring_size, METH_VARARGS,
     "colring_size(ring) -> claimed, unconsumed depth"},
    {"colring_capacity", colring_capacity, METH_VARARGS,
     "colring_capacity(ring) -> power-of-two slot count"},
    {"colring_hwm", colring_hwm, METH_VARARGS,
     "colring_hwm(ring) -> claimed-depth high-water mark"},
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
