"""The knee of an open-loop cell: one session, windows at rising fixed
rates, each primed as the cell's runs are (``prime_s`` of the traffic at
the rate before the window opens) and drained before the next.  For each rate it prints the requests
offered and finished, the TTFT and TPOT tails, the tokens a second and the
backlog at the window's end (requests waiting and decoding).

    python3 h100bench/sweep.py --workload <name> --seed <n> --seconds <s> --rates <r> [<r> ...]
        [--traffic-seeds <n> ...]

The knee is the highest rate whose backlog at the end stays at about the
slots' worth and whose TTFT does not grow with the window.  With
``--traffic-seeds`` each rate runs once a traffic seed (the weights stay
``--seed``'s): the spread of the tails over the order of the same requests.  It is found
once, when a cell is defined; the cell's traffic then holds a fixed rate.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--traffic-seeds", type=int, nargs="+")
    args = ap.parse_args()

    import torch

    from h100bench.harness import program, runner, spec, stats, traffic, window

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda")
    cfg = program.port_config(cell.config)
    vocab = cell.config["vocab_size"]
    params = program.make_params(cfg, cell.config, args.seed, dev, cell.config["weights_home"])
    session = program.open_session(cfg, spec.session_args(cell.config, cell.traffic), params, dev)
    del params
    torch.set_num_threads(runner.HOST_THREADS)
    try:
        runner.warm(session, cell.traffic, vocab)
        for rate, tseed in [(r, t) for r in args.rates for t in args.traffic_seeds or [args.seed]]:
            tspec = dict(cell.traffic, phases=[{"share": 1.0, "rate_rps": rate}])
            reqs, start = traffic.timeline(tspec, tseed, args.seconds, vocab)
            win = window.run(window.Loop(session, dev), reqs, args.seconds, False, start)
            backlog = sum(1 for s in win.served if not s.done)
            finished = sum(1 for s in stats.in_window(win) if s.done and s.token_s[-1] >= 0)
            offered = sum(1 for s in win.served if s.due_s >= 0)
            row = {"rate_rps": rate, "traffic_seed": tseed, "offered": offered,
                   "finished": finished,
                   "backlog_at_end": backlog,
                   "in_flight_at_start": sum(1 for s in win.served if s.token_s
                                             and s.token_s[0] < 0
                                             and (not s.done or s.token_s[-1] >= 0)),
                   "ttft_p50_ms": 1e3 * stats.percentile(stats.ttfts(win), 50),
                   "ttft_p90_ms": 1e3 * stats.percentile(stats.ttfts(win), 90),
                   "tpot_p90_ms": 1e3 * (stats.percentile(stats.token_gaps(win), 90) or 0.0),
                   "tok_s": stats.tokens_in_window(win) / args.seconds,
                   "step_ms_p50": 1e3 * (stats.percentile(stats.step_walls(win), 50) or 0.0),
                   "prefill_ms_p50": 1e3 * (stats.percentile(stats.prefill_walls(win), 50) or 0.0),
                   "gen_lag_p90_ms": 1e3 * (stats.percentile(win.gen_lag_s, 90) or 0.0)}
            print(json.dumps(row), flush=True)
            t0 = time.perf_counter()
            while session.active:  # drain before the next rate
                session.step()
            print(f"drained in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    finally:
        session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
