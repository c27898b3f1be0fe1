/*
 * Native implementation of the graph_framework_tpu C API over the PyTorch
 * port (libgraph_tpu_torch.so).
 *
 * The same source as capi/graph_c_binding.c, which drives the JAX package,
 * but for the module it imports: it embeds CPython (the runtime analogue of
 * the reference's in-process LLVM/NVRTC JIT, cpu_context.hpp/
 * cuda_context.hpp) and drives the expression/workflow layer in
 * graph_framework_tpu_torch/capi_bridge.py, on the card unless
 * GRAPH_TORCH_DEVICE names another device.  It exports the same symbols, so
 * an embedder links either library.  Graph nodes cross the boundary as
 * owned PyObject pointers.
 *
 * Thread model: the embedding is single-interpreter; calls acquire the GIL,
 * so the library is safe to call from multiple host threads (the reference
 * serializes shared state with mutexes similarly, output.hpp:18).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "graph_c_binding.h"

static PyObject *bridge = NULL;

static size_t element_size(enum graph_type t) {
    switch (t) {
    case FLOAT: return 4;
    case DOUBLE: return 8;
    case COMPLEX_FLOAT: return 8;
    default: return 16;
    }
}

static void fatal_if_err(const char *where) {
    if (PyErr_Occurred()) {
        fprintf(stderr, "graph_c_binding: python error in %s:\n", where);
        PyErr_Print();
        exit(1);
    }
}

static void ensure_python(void) {
    if (bridge != NULL) {
        return;
    }
    if (!Py_IsInitialized()) {
        Py_Initialize();
    }
    /* make the repository importable when launched from elsewhere */
    const char *root = getenv("GRAPH_TPU_ROOT");
    PyObject *sys_path = PySys_GetObject("path");
    if (root != NULL) {
        PyObject *p = PyUnicode_FromString(root);
        PyList_Insert(sys_path, 0, p);
        Py_DECREF(p);
    }
    bridge = PyImport_ImportModule("graph_framework_tpu_torch.capi_bridge");
    fatal_if_err("import graph_framework_tpu_torch.capi_bridge");
}

static PyObject *ctx_py(STRUCT_TAG graph_c_context *c) {
    return (PyObject *)c->impl;
}

/* call a bridge function; returns a new reference */
static PyObject *call(const char *name, PyObject *args) {
    PyObject *fn = PyObject_GetAttrString(bridge, name);
    fatal_if_err(name);
    PyObject *out = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    fatal_if_err(name);
    return out;
}

struct graph_c_context *graph_construct_context(const enum graph_type type,
                                                const bool use_safe_math) {
    ensure_python();
    struct graph_c_context *c = malloc(sizeof(*c));
    c->type = type;
    c->safe_math = use_safe_math;
    c->impl = call("make_context",
                   Py_BuildValue("(ii)", (int)type, (int)use_safe_math));
    return c;
}

void graph_destroy_context(struct graph_c_context *c) {
    if (c == NULL) {
        return;
    }
    Py_XDECREF(ctx_py(c));
    free(c);
}

/* -- node constructors --------------------------------------------------- */

graph_node graph_variable(struct graph_c_context *c, const size_t size,
                          const char *symbol) {
    return call("variable", Py_BuildValue("(Ons)", ctx_py(c),
                                          (Py_ssize_t)size, symbol));
}

graph_node graph_constant(struct graph_c_context *c, const double value) {
    return call("constant", Py_BuildValue("(Od)", ctx_py(c), value));
}

graph_node graph_constant_c(struct graph_c_context *c, const double re,
                            const double im) {
    return call("constant_c", Py_BuildValue("(Odd)", ctx_py(c), re, im));
}

void graph_set_variable(struct graph_c_context *c, graph_node var,
                        const void *source) {
    PyObject *v = (PyObject *)var;
    PyObject *size = PyObject_GetAttrString(v, "size");
    Py_ssize_t n = PyLong_AsSsize_t(size);
    Py_DECREF(size);
    PyObject *mem = PyMemoryView_FromMemory(
        (char *)source, n * element_size(c->type), PyBUF_READ);
    Py_DECREF(call("set_variable",
                   Py_BuildValue("(OON)", ctx_py(c), v, mem)));
}

graph_node graph_pseudo_variable(struct graph_c_context *c,
                                 graph_node node) {
    return call("pseudo_variable", Py_BuildValue("(OO)", ctx_py(c), node));
}

graph_node graph_remove_pseudo(struct graph_c_context *c, graph_node node) {
    return call("remove_pseudo", Py_BuildValue("(OO)", ctx_py(c), node));
}

#define BINARY(OP)                                                          \
    graph_node graph_##OP(struct graph_c_context *c, graph_node l,          \
                          graph_node r) {                                   \
        return call(#OP, Py_BuildValue("(OOO)", ctx_py(c), l, r));          \
    }

#define UNARY(OP)                                                           \
    graph_node graph_##OP(struct graph_c_context *c, graph_node a) {        \
        return call(#OP, Py_BuildValue("(OO)", ctx_py(c), a));              \
    }

BINARY(add)
BINARY(sub)
BINARY(mul)
BINARY(div)
BINARY(pow)
BINARY(atan)
UNARY(sqrt)
UNARY(exp)
UNARY(log)
UNARY(erfi)
UNARY(sin)
UNARY(cos)

graph_node graph_random_state(struct graph_c_context *c,
                              const uint32_t seed) {
    return call("random_state", Py_BuildValue("(OI)", ctx_py(c), seed));
}

graph_node graph_random(struct graph_c_context *c, graph_node state) {
    PyObject *s = state ? (PyObject *)state : Py_None;
    return call("random", Py_BuildValue("(OO)", ctx_py(c), s));
}

graph_node graph_piecewise_1D(struct graph_c_context *c, graph_node arg,
                              const double scale, const double offset,
                              const void *source,
                              const size_t source_size) {
    PyObject *mem = PyMemoryView_FromMemory(
        (char *)source, source_size * element_size(c->type), PyBUF_READ);
    return call("piecewise_1d",
                Py_BuildValue("(OOddNn)", ctx_py(c), arg, scale, offset,
                              mem, (Py_ssize_t)source_size));
}

graph_node graph_piecewise_2D(struct graph_c_context *c,
                              const size_t num_cols, graph_node x_arg,
                              const double x_scale, const double x_offset,
                              graph_node y_arg, const double y_scale,
                              const double y_offset, const void *source,
                              const size_t source_size) {
    PyObject *mem = PyMemoryView_FromMemory(
        (char *)source, source_size * element_size(c->type), PyBUF_READ);
    return call("piecewise_2d",
                Py_BuildValue("(OnOddOddNn)", ctx_py(c),
                              (Py_ssize_t)num_cols, x_arg, x_scale,
                              x_offset, y_arg, y_scale, y_offset, mem,
                              (Py_ssize_t)source_size));
}

graph_node graph_index_1D(struct graph_c_context *c, graph_node variable,
                          graph_node arg, const double scale,
                          const double offset) {
    return call("index_1d", Py_BuildValue("(OOOdd)", ctx_py(c), variable,
                                          arg, scale, offset));
}

graph_node graph_index_2D(struct graph_c_context *c, graph_node variable,
                          const size_t num_cols, graph_node x_arg,
                          const double x_scale, const double x_offset,
                          graph_node y_arg, const double y_scale,
                          const double y_offset) {
    return call("index_2d",
                Py_BuildValue("(OOnOddOdd)", ctx_py(c), variable,
                              (Py_ssize_t)num_cols, x_arg, x_scale,
                              x_offset, y_arg, y_scale, y_offset));
}

graph_node graph_df(struct graph_c_context *c, graph_node num,
                    graph_node den) {
    return call("df", Py_BuildValue("(OOO)", ctx_py(c), num, den));
}

size_t graph_get_max_concurrency(struct graph_c_context *c) {
    PyObject *r = call("get_max_concurrency",
                       Py_BuildValue("(O)", ctx_py(c)));
    size_t n = (size_t)PyLong_AsSsize_t(r);
    Py_DECREF(r);
    return n;
}

void graph_set_device_number(struct graph_c_context *c, const size_t n) {
    Py_DECREF(call("set_device_number",
                   Py_BuildValue("(On)", ctx_py(c), (Py_ssize_t)n)));
}

/* -- workflow ------------------------------------------------------------ */

static PyObject *node_list(graph_node *nodes, size_t n) {
    PyObject *list = PyList_New((Py_ssize_t)n);
    for (size_t i = 0; i < n; i++) {
        PyObject *o = (PyObject *)nodes[i];
        Py_INCREF(o);
        PyList_SET_ITEM(list, (Py_ssize_t)i, o);
    }
    return list;
}

void graph_add_pre_item(struct graph_c_context *c,
                        graph_node *inputs, size_t num_inputs,
                        graph_node *outputs, size_t num_outputs,
                        graph_node *map_inputs, graph_node *map_outputs,
                        size_t num_maps, graph_node random_state,
                        const char *name, const size_t size) {
    (void)random_state;
    Py_DECREF(call("add_pre_item", Py_BuildValue(
        "(ONNNNsn)", ctx_py(c), node_list(inputs, num_inputs),
        node_list(outputs, num_outputs), node_list(map_inputs, num_maps),
        node_list(map_outputs, num_maps), name, (Py_ssize_t)size)));
}

void graph_add_item(struct graph_c_context *c,
                    graph_node *inputs, size_t num_inputs,
                    graph_node *outputs, size_t num_outputs,
                    graph_node *map_inputs, graph_node *map_outputs,
                    size_t num_maps, graph_node random_state,
                    const char *name, const size_t size) {
    (void)random_state;
    Py_DECREF(call("add_item", Py_BuildValue(
        "(ONNNNsn)", ctx_py(c), node_list(inputs, num_inputs),
        node_list(outputs, num_outputs), node_list(map_inputs, num_maps),
        node_list(map_outputs, num_maps), name, (Py_ssize_t)size)));
}

void graph_add_converge_item(struct graph_c_context *c,
                             graph_node *inputs, size_t num_inputs,
                             graph_node *outputs, size_t num_outputs,
                             graph_node *map_inputs,
                             graph_node *map_outputs, size_t num_maps,
                             graph_node random_state, const char *name,
                             const size_t size, const double tol,
                             const size_t max_iter) {
    (void)random_state;
    Py_DECREF(call("add_converge_item", Py_BuildValue(
        "(ONNNNsndn)", ctx_py(c), node_list(inputs, num_inputs),
        node_list(outputs, num_outputs), node_list(map_inputs, num_maps),
        node_list(map_outputs, num_maps), name, (Py_ssize_t)size, tol,
        (Py_ssize_t)max_iter)));
}

void graph_compile(struct graph_c_context *c) {
    Py_DECREF(call("compile", Py_BuildValue("(O)", ctx_py(c))));
}

void graph_pre_run(struct graph_c_context *c) {
    Py_DECREF(call("pre_run", Py_BuildValue("(O)", ctx_py(c))));
}

void graph_run(struct graph_c_context *c) {
    Py_DECREF(call("run", Py_BuildValue("(O)", ctx_py(c))));
}

void graph_wait(struct graph_c_context *c) {
    Py_DECREF(call("wait", Py_BuildValue("(O)", ctx_py(c))));
}

void graph_copy_to_device(struct graph_c_context *c, graph_node node,
                          void *source) {
    graph_set_variable(c, node, source);
}

void graph_copy_to_host(struct graph_c_context *c, graph_node node,
                        void *destination) {
    PyObject *bytes = call("copy_to_host",
                           Py_BuildValue("(OO)", ctx_py(c), node));
    char *buf;
    Py_ssize_t len;
    PyBytes_AsStringAndSize(bytes, &buf, &len);
    memcpy(destination, buf, (size_t)len);
    Py_DECREF(bytes);
}

void graph_print(struct graph_c_context *c, const size_t index,
                 graph_node *nodes, const size_t num_nodes) {
    Py_DECREF(call("print_nodes", Py_BuildValue(
        "(OnN)", ctx_py(c), (Py_ssize_t)index,
        node_list(nodes, num_nodes))));
}
