/* Minimal reactive core (the role Vue's reactivity + Pinia play in the
 * reference frontend, Visualization_frontend/src/store/training.ts).
 *
 * - signal(v)    -> { value, subscribe(fn) }: assignment notifies subscribers
 * - computed(fn, deps) -> read-only signal recomputed when any dep changes
 * - effect(fn, deps)   -> run fn now and on every dep change
 * - defineStore(setup)  -> lazy singleton factory (Pinia's defineStore shape)
 */

export function signal(initial) {
  let v = initial;
  const subs = new Set();
  return {
    get value() {
      return v;
    },
    set value(next) {
      if (Object.is(next, v)) return;
      v = next;
      for (const fn of subs) fn(v);
    },
    /* For arrays/objects mutated in place: re-notify without replacing. */
    touch() {
      for (const fn of subs) fn(v);
    },
    subscribe(fn) {
      subs.add(fn);
      return () => subs.delete(fn);
    },
  };
}

export function computed(fn, deps) {
  const out = signal(fn());
  const recompute = () => {
    out.value = fn();
  };
  for (const d of deps) d.subscribe(recompute);
  return out;
}

export function effect(fn, deps) {
  const disposers = deps.map((d) => d.subscribe(() => fn()));
  fn();
  return () => disposers.forEach((dispose) => dispose());
}

export function defineStore(setup) {
  let instance = null;
  return () => instance || (instance = setup());
}
