"""Scene definition, camera, materials, TorchScene and instantiation."""
