"""Core datatypes, the cost model, the planner (flow network, assignment,
deployment search, switch planning, the orchestrator) and the workload
predictor."""
