from .loader import NativeStager, build_native

__all__ = ["NativeStager", "build_native"]
