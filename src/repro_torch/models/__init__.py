from .transformer import Model, Segment, build_plan

__all__ = ["Model", "Segment", "build_plan"]
