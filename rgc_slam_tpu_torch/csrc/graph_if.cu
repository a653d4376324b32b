// Conditional IF nodes for a CUDA graph that PyTorch is capturing.
//
// PyTorch captures a stream into a graph (torch.cuda.graph); this file lets
// Python put a conditional IF node into that graph and capture the node's
// body from a second stream, so that each replay runs the body only where a
// bool on the device holds.  rgc_graph_if_begin, on the capturing stream:
//
//   1. makes a conditional handle in the graph being captured;
//   2. launches rgc_set_if, one thread that copies *pred into the handle, so
//      the replay reads pred where the graph reaches this point;
//   3. adds the IF node after it, and makes the node the capturing stream's
//      only dependency, so the capture goes on after the node;
//   4. starts capturing the body stream into the node's body graph.
//
// The caller runs the body's operations on the body stream, then calls
// rgc_graph_if_end, which ends the body's capture.  Nothing here runs
// outside a capture, and nothing reads the device from the host.
// Needs CUDA 12.4 or later (conditional nodes whose bodies hold memsets and
// copies, cudaStreamBeginCaptureToGraph).
#include <cuda_runtime.h>

__global__ void rgc_set_if(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int rgc_graph_if_begin(const void* pred, void* stream_p, void* body_p) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
    cudaStream_t body = static_cast<cudaStream_t>(body_p);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr, nullptr);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    rgc_set_if<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                         nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int rgc_graph_if_end(void* body_p) {
    cudaGraph_t graph;
    return cudaStreamEndCapture(static_cast<cudaStream_t>(body_p), &graph);
}
