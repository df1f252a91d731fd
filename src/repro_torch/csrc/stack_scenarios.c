/* One pass over lists of JobSpec objects into the (S, J) scenario tables
 * of cluster/workload.py::stack_scenarios.
 *
 * A host library with a plain C interface, built by kernels/build.py with
 * the host C compiler and loaded with ctypes.PyDLL, so the call holds the
 * GIL.  It takes the input only where it can vouch that its tables are the
 * plain path's, bit for bit: the outer sequence and every trace are exact
 * lists, every job is exactly of the given type, job_id and nodes are exact
 * ints (job_id equal to the job's position, nodes within int32) and the
 * three times exact floats that round to float32 without overflow.  It
 * checks the submission order on the float32 values as the plain path's
 * np.diff(sub) < 0 does: a difference below zero, so NaN and inf compare as
 * they do there.  Anything else returns -1 with no Python error set, and the
 * caller takes the plain path, which returns or raises as it always has.
 * Rows are written in place; padding slots are left as the caller made them.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdint.h>

enum { F_ID, F_SUBMIT, F_NODES, F_EST, F_TRUE, N_FIELDS };
static const char *FIELD_NAMES[N_FIELDS] = {
    "job_id", "submit_t", "nodes", "est_runtime", "true_runtime"};
static PyObject *names[N_FIELDS];   /* interned once, kept for the process */

static int intern_names(void)
{
    for (int i = 0; i < N_FIELDS; i++) {
        if (names[i] == NULL) {
            names[i] = PyUnicode_InternFromString(FIELD_NAMES[i]);
            if (names[i] == NULL)
                return -1;
        }
    }
    return 0;
}

/* 0 and the value where the field is an exact int within int32. */
static int read_i32(PyObject *job, int field, long *out)
{
    PyObject *v = PyObject_GetAttr(job, names[field]);
    if (v == NULL)
        return -1;
    int ok = PyLong_CheckExact(v);
    if (ok) {
        int overflow;
        long x = PyLong_AsLongAndOverflow(v, &overflow);
        ok = !overflow && !(x == -1 && PyErr_Occurred())
             && x >= INT32_MIN && x <= INT32_MAX;
        *out = x;
    }
    Py_DECREF(v);
    return ok ? 0 : -1;
}

/* 0 and the value as float32 where the field is an exact float that does
 * not overflow float32 (the plain path's cast would warn there). */
static int read_f32(PyObject *job, int field, float *out)
{
    PyObject *v = PyObject_GetAttr(job, names[field]);
    if (v == NULL)
        return -1;
    int ok = PyFloat_CheckExact(v);
    if (ok) {
        double d = PyFloat_AS_DOUBLE(v);
        float f = (float)d;
        ok = !(isinf(f) && isfinite(d));
        *out = f;
    }
    Py_DECREF(v);
    return ok ? 0 : -1;
}

/* Writes traces[s][j] into slot s * J + j of the five tables for every
 * trace; returns the jobs written, or -1 where the plain path must run. */
Py_ssize_t stack_rows(PyObject *traces, PyObject *job_type, Py_ssize_t S,
                      Py_ssize_t J, float *submit_t, int32_t *nodes,
                      float *est_runtime, float *true_runtime,
                      uint8_t *valid)
{
    Py_ssize_t written = 0;
    if (intern_names() < 0)
        goto fail;
    if (!PyList_CheckExact(traces) || PyList_GET_SIZE(traces) != S)
        return -1;
    for (Py_ssize_t s = 0; s < S; s++) {
        PyObject *trace = PyList_GET_ITEM(traces, s);
        if (!PyList_CheckExact(trace))
            return -1;
        Py_ssize_t n = PyList_GET_SIZE(trace);
        if (n > J)
            return -1;
        Py_ssize_t row = s * J;
        float prev = 0.0f;
        for (Py_ssize_t j = 0; j < n; j++) {
            PyObject *job = PyList_GET_ITEM(trace, j);
            long id, nd;
            float sub, est, tru;
            if ((PyObject *)Py_TYPE(job) != job_type
                || read_i32(job, F_ID, &id) || id != j
                || read_f32(job, F_SUBMIT, &sub)
                || (j > 0 && sub - prev < 0.0f)
                || read_i32(job, F_NODES, &nd)
                || read_f32(job, F_EST, &est)
                || read_f32(job, F_TRUE, &tru))
                goto fail;
            prev = sub;
            submit_t[row + j] = sub;
            nodes[row + j] = (int32_t)nd;
            est_runtime[row + j] = est;
            true_runtime[row + j] = tru;
            valid[row + j] = 1;
        }
        written += n;
    }
    return written;
fail:
    PyErr_Clear();
    return -1;
}
