from vkr.scene.gltf import GltfScene, Material, Primitive, DrawCall, load_gltf
from vkr.scene.scene import CompiledScene, compile_scene, load_scene, build_mip_pyramid
from vkr.scene.camera import Camera
from vkr.scene.procedural import colonnade_scene, build_colonnade
