from . import constraints, costs, dynamics, problem
