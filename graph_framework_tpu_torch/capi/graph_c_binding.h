/*
 * C API of graph_framework_tpu, over the PyTorch port.
 *
 * Function-for-function counterpart of the reference's C binding
 * (reference: graph_c_binding/graph_c_binding.h:177-639) so legacy
 * embedders and the Fortran wrapper keep working, implemented by embedding
 * CPython and driving the PyTorch expression layer
 * (graph_framework_tpu_torch/expr.py) - see graph_c_binding.c.  The same
 * declarations as capi/graph_c_binding.h (the JAX package's library).
 *
 * Nodes are opaque handles; contexts select the scalar type
 * (float/double/complex float/complex double) and safe-math behaviour.
 */

#ifndef GRAPH_TPU_C_BINDING_H
#define GRAPH_TPU_C_BINDING_H

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#define STRUCT_TAG
#else
#define STRUCT_TAG struct
#endif

typedef void *graph_node;

enum graph_type {
    FLOAT,
    DOUBLE,
    COMPLEX_FLOAT,
    COMPLEX_DOUBLE
};

struct graph_c_context {
    enum graph_type type;
    bool safe_math;
    void *impl;   /* python-side context (private) */
};

/* context lifecycle */
STRUCT_TAG graph_c_context *graph_construct_context(const enum graph_type type,
                                                    const bool use_safe_math);
void graph_destroy_context(STRUCT_TAG graph_c_context *c);

/* leaf nodes */
graph_node graph_variable(STRUCT_TAG graph_c_context *c, const size_t size,
                          const char *symbol);
graph_node graph_constant(STRUCT_TAG graph_c_context *c, const double value);
graph_node graph_constant_c(STRUCT_TAG graph_c_context *c,
                            const double real_value, const double img_value);
void graph_set_variable(STRUCT_TAG graph_c_context *c, graph_node var,
                        const void *source);
graph_node graph_pseudo_variable(STRUCT_TAG graph_c_context *c,
                                 graph_node node);
graph_node graph_remove_pseudo(STRUCT_TAG graph_c_context *c,
                               graph_node node);

/* operators */
graph_node graph_add(STRUCT_TAG graph_c_context *c, graph_node l,
                     graph_node r);
graph_node graph_sub(STRUCT_TAG graph_c_context *c, graph_node l,
                     graph_node r);
graph_node graph_mul(STRUCT_TAG graph_c_context *c, graph_node l,
                     graph_node r);
graph_node graph_div(STRUCT_TAG graph_c_context *c, graph_node l,
                     graph_node r);
graph_node graph_sqrt(STRUCT_TAG graph_c_context *c, graph_node a);
graph_node graph_exp(STRUCT_TAG graph_c_context *c, graph_node a);
graph_node graph_log(STRUCT_TAG graph_c_context *c, graph_node a);
graph_node graph_pow(STRUCT_TAG graph_c_context *c, graph_node l,
                     graph_node r);
graph_node graph_erfi(STRUCT_TAG graph_c_context *c, graph_node a);
graph_node graph_sin(STRUCT_TAG graph_c_context *c, graph_node a);
graph_node graph_cos(STRUCT_TAG graph_c_context *c, graph_node a);
graph_node graph_atan(STRUCT_TAG graph_c_context *c, graph_node left,
                      graph_node right);

/* random numbers */
graph_node graph_random_state(STRUCT_TAG graph_c_context *c,
                              const uint32_t seed);
graph_node graph_random(STRUCT_TAG graph_c_context *c, graph_node state);

/* table lookups */
graph_node graph_piecewise_1D(STRUCT_TAG graph_c_context *c, graph_node arg,
                              const double scale, const double offset,
                              const void *source, const size_t source_size);
graph_node graph_piecewise_2D(STRUCT_TAG graph_c_context *c,
                              const size_t num_cols, graph_node x_arg,
                              const double x_scale, const double x_offset,
                              graph_node y_arg, const double y_scale,
                              const double y_offset, const void *source,
                              const size_t source_size);
graph_node graph_index_1D(STRUCT_TAG graph_c_context *c, graph_node variable,
                          graph_node arg, const double scale,
                          const double offset);
graph_node graph_index_2D(STRUCT_TAG graph_c_context *c, graph_node variable,
                          const size_t num_cols, graph_node x_arg,
                          const double x_scale, const double x_offset,
                          graph_node y_arg, const double y_scale,
                          const double y_offset);

/* autodiff */
graph_node graph_df(STRUCT_TAG graph_c_context *c, graph_node num,
                    graph_node den);

/* device management */
size_t graph_get_max_concurrency(STRUCT_TAG graph_c_context *c);
void graph_set_device_number(STRUCT_TAG graph_c_context *c, const size_t n);

/* workflow */
void graph_add_pre_item(STRUCT_TAG graph_c_context *c,
                        graph_node *inputs, size_t num_inputs,
                        graph_node *outputs, size_t num_outputs,
                        graph_node *map_inputs, graph_node *map_outputs,
                        size_t num_maps, graph_node random_state,
                        const char *name, const size_t size);
void graph_add_item(STRUCT_TAG graph_c_context *c,
                    graph_node *inputs, size_t num_inputs,
                    graph_node *outputs, size_t num_outputs,
                    graph_node *map_inputs, graph_node *map_outputs,
                    size_t num_maps, graph_node random_state,
                    const char *name, const size_t size);
void graph_add_converge_item(STRUCT_TAG graph_c_context *c,
                             graph_node *inputs, size_t num_inputs,
                             graph_node *outputs, size_t num_outputs,
                             graph_node *map_inputs, graph_node *map_outputs,
                             size_t num_maps, graph_node random_state,
                             const char *name, const size_t size,
                             const double tol, const size_t max_iter);
void graph_compile(STRUCT_TAG graph_c_context *c);
void graph_pre_run(STRUCT_TAG graph_c_context *c);
void graph_run(STRUCT_TAG graph_c_context *c);
void graph_wait(STRUCT_TAG graph_c_context *c);
void graph_copy_to_device(STRUCT_TAG graph_c_context *c, graph_node node,
                          void *source);
void graph_copy_to_host(STRUCT_TAG graph_c_context *c, graph_node node,
                        void *destination);
void graph_print(STRUCT_TAG graph_c_context *c, const size_t index,
                 graph_node *nodes, const size_t num_nodes);

#ifdef __cplusplus
}
#endif

#endif /* GRAPH_TPU_C_BINDING_H */
