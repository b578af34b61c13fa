"""vkr — a real-time deferred renderer in JAX (XLA + Pallas kernels).

Brand-new implementation of the capabilities of the reference Vulkan renderer
(FptrP/vk-renderer, surveyed in SURVEY.md): glTF scene loading, tile-binned
rasterization into a G-buffer, hi-Z pyramid, GTAO, stochastic hi-Z SSR, TAA,
deferred PBR shading and octahedral light probes — expressed as a pure,
jit-traced pass DAG over HBM-resident arrays with an explicit history-state
pytree instead of a barrier-tracking rendergraph.

Layer map (mirrors SURVEY.md §1, reimagined as array programs):

  core/      — frame state pytree, pass-graph orchestration, kernel registry,
               format emulation (the reference's gpu/ + rendergraph/ layers,
               which mostly dissolve into XLA dataflow)
  mathlib/   — camera/projection math (GLM-convention), octahedral encodings,
               BRDF math, halton sequences
  scene/     — glTF loader -> numpy SoA, texture atlas + mip gen, camera
               (reference src/scene/)
  raster/    — the tile-binned visibility rasterizer, a Triton kernel
               through Pallas (replaces Vulkan fixed-function raster)
  passes/    — the image-space pass chain, one module per reference pass
               (reference src/*.cpp + src/shaders/)
  parallel/  — multi-device sharding of the pixel grid (shard_map over a mesh);
               optional extension beyond reference parity
  native/    — C++ asset-pipeline runtime (glTF parse, mesh merge, mip gen)
"""

__version__ = "0.1.0"
