// Conditional CUDA graphs for the Engine's device loop (run/device_loop.py).
//
// PyTorch captures the loop's two parts as graphs of their own (the neighbor
// rebuild and the check_every-step segment).  lpt_graph_if_then joins them
// into one graph of the loop's iteration:
//
//     set_condition(pred) -> IF (pred) { rebuild } -> segment
//
// a one-thread kernel reads the device flag `pred` and sets the handle of an
// IF conditional node (CUDA 12.3+), whose body is the rebuild graph; the
// segment follows the conditional node.  Both parts enter as child graph
// nodes, i.e. copies of their nodes: the memory they address stays owned by
// PyTorch's graphs (and their pool), which must outlive the executable.
// Replaying the iteration m times takes m launches and no host decision.
//
// lpt_stamp times spans on the device's own clock (run/timers.py): a
// one-thread kernel adds sign * %globaltimer (ns) to an int64 slot, minus
// at a span's start and plus at its end, so the slot sums its spans.  It
// launches on the caller's stream, so a stream capture records it as a
// node between the span's work and its neighbours': inside the IF body a
// rebuild is timed only when it runs.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t ndeps,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, ndeps, params);
#else
  return cudaGraphAddNode(node, graph, deps, ndeps, params);
#endif
}

__global__ void stamp_kernel(long long* slot, int sign) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot += sign * (long long)t;
}

}  // namespace

extern "C" int lpt_stamp(long long* slot, int sign, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(slot, sign);
  return (int)cudaGetLastError();
}

// out: a new graph, set_condition(pred) -> IF (pred) { body } -> tail.
// body and tail stay the caller's (they are copied).
extern "C" int lpt_graph_if_then(void* body, void* tail, const bool* pred,
                                 void** out) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t set_node, if_node, body_node, tail_node;
  cudaKernelNodeParams kp = {};
  void* args[] = {&handle, &pred};
  cudaGraphNodeParams cp = {};
  e = cudaGraphConditionalHandleCreate(&handle, g, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) goto fail;
  kp.func = (void*)set_condition_kernel;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  e = cudaGraphAddKernelNode(&set_node, g, nullptr, 0, &kp);
  if (e != cudaSuccess) goto fail;
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  e = add_node(&if_node, g, &set_node, 1, &cp);
  if (e != cudaSuccess) goto fail;
  e = cudaGraphAddChildGraphNode(&body_node, cp.conditional.phGraph_out[0],
                                 nullptr, 0, (cudaGraph_t)body);
  if (e != cudaSuccess) goto fail;
  e = cudaGraphAddChildGraphNode(&tail_node, g, &if_node, 1,
                                 (cudaGraph_t)tail);
  if (e != cudaSuccess) goto fail;
  *out = (void*)g;
  return 0;
fail:
  cudaGraphDestroy(g);
  return (int)e;
}

extern "C" int lpt_graph_instantiate(void* graph, void** exec) {
  cudaGraphExec_t x = nullptr;
  const cudaError_t e = cudaGraphInstantiate(&x, (cudaGraph_t)graph, 0);
  *exec = (void*)x;
  return (int)e;
}

extern "C" int lpt_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Either handle may be null.
extern "C" int lpt_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}
