"""The joins' share of the chip's bfloat16 peak (%): model operations of
the prompts joined in the window (their real tokens, padding not counted,
and each one's read-out) over the window's join seconds times 989
TFLOP/s."""
import portbench.flops as fl


def read(run):
    s = run.session
    j0, j1 = s.join0, s.join1
    sec = j1["mean_join_s"] * j1["joins"] - j0["mean_join_s"] * j0["joins"]
    joined = [q for q in s.window_reqs()
              if q.t_first is not None and s.w0 <= q.t_first < s.w1]
    if sec <= 0 or not joined:
        return None
    work = sum(fl.prompt_flops(run.shapes, q.plen) for q in joined)
    return 100.0 * work / (sec * fl.PEAK_FLOPS_BF16)
