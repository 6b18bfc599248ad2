"""The deflate planner: ``inflate_plan.cc`` (the port's C++ copy of the JAX
package's planner, built with g++) and its numpy side, ``plan``."""
