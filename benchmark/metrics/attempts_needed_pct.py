"""Attempts (backward pass + line search) the fleet's solves needed, over
the attempts `ilqr.solver.device_solve` ran (every trip runs both): the
program's own count (`MPCDiagnostics.attempts`, summed over the window)."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("attempts_run"):
        return None
    return 100.0 * c["attempts_needed"] / c["attempts_run"]
