from .engine import ServeEngine, Request
