from .transformer import Model, Segment, build_plan, make_model

__all__ = ["Model", "Segment", "build_plan", "make_model"]
