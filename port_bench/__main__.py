import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from port_bench.run import main

    raise SystemExit(main(t_start=T_START))
